"""The one traffic generator: it reads a mix file and draws, from the seed,
the pool's tokens and each request's items and output length.

A request is a closed-loop client's next message: the pool items its
prompt is made of (a RAG request's passages in retrieval order, a chat
turn's conversation) and the new tokens it asks for. Every wave of
`batch` requests asks for the same multiset of output lengths, the
distribution's quantiles at (j + 0.5) / batch, in an order drawn from
the seed: each seed gives the engine the same work, in another order.
(The engine decodes a wave to its longest request, so lengths drawn
independently would make a wave's length, and a run's work, depend on
the seed.)
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import List

import numpy as np

# independent streams of one seed
POOL, ITEMS, LENGTHS, SAMPLE, RANKS = range(5)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed & ((1 << 64) - 1), stream])


@dataclass
class Request:
    rid: int
    items: np.ndarray        # pool indices, in prompt order
    max_new: int


def length_quantile(dist: dict, u: float) -> int:
    """The output length at quantile u of `dist`: log_uniform(min, max),
    or log_normal(median, sigma) cut to [min, max]."""
    if dist["dist"] == "log_uniform":
        lo, hi = math.log(dist["min"]), math.log(dist["max"])
        return int(round(math.exp(lo + (hi - lo) * u)))
    if dist["dist"] == "log_normal":
        x = dist["median"] * math.exp(dist["sigma"] * NormalDist().inv_cdf(u))
        return int(min(max(round(x), dist["min"]), dist["max"]))
    raise ValueError(f"unknown output length distribution {dist}")


def wave_lengths(dist: dict, batch: int) -> List[int]:
    """The output lengths of a wave: `dist`'s quantiles at (j + 0.5) /
    batch, j < batch."""
    return [length_quantile(dist, (j + 0.5) / batch) for j in range(batch)]


class Traffic:
    """A mix's requests for one seed and one engine batch."""

    def __init__(self, mix: dict, vocab: int, batch: int, seed: int):
        self.mix, self.vocab, self.batch, self.seed = mix, vocab, batch, seed
        p = mix["prompt"]
        self.per_request = p.get("items", 1)
        self.item_tokens = p["item_tokens"]
        self.prompt_len = self.per_request * self.item_tokens
        self.n_items = mix["pool"]["items"]
        self._items = rng_for(seed, ITEMS)
        self._lengths = rng_for(seed, LENGTHS)
        self._next = 0
        pop = mix["pool"]["popularity"]
        if pop["dist"] == "zipf":
            ranks = np.arange(1, self.n_items + 1, dtype=np.float64)
            w = ranks ** -pop["s"]
            self._cdf = np.cumsum(w / w.sum())
            # rank r is item perm[r]: the popular items lie anywhere
            self._perm = rng_for(seed, RANKS).permutation(self.n_items)
        elif pop["dist"] == "uniform":
            self._cdf = None
        else:
            raise ValueError(f"unknown popularity {pop}")
        self.max_new = max(wave_lengths(mix["new_tokens"], batch))

    def pool(self) -> np.ndarray:
        """The pool's tokens, (items, item_tokens) int32 in [0, vocab)."""
        return rng_for(self.seed, POOL).integers(
            0, self.vocab, (self.n_items, self.item_tokens), dtype=np.int32)

    def draw(self, n: int) -> np.ndarray:
        """n pool items drawn by the mix's popularity."""
        if self._cdf is None:
            return self._items.integers(0, self.n_items, n)
        r = np.searchsorted(self._cdf, self._items.random(n), side="right")
        return self._perm[np.minimum(r, self.n_items - 1)]

    def _items_of_one(self) -> np.ndarray:
        """A request's distinct items: draws until `per_request` differ,
        in the order first drawn (retrieval order)."""
        got: List[int] = []
        seen = set()
        while len(got) < self.per_request:
            for i in self.draw(self.per_request - len(got)):
                if int(i) not in seen:
                    seen.add(int(i))
                    got.append(int(i))
        return np.asarray(got, dtype=np.int64)

    def wave(self) -> List[Request]:
        """The next `batch` requests."""
        lengths = self._lengths.permutation(
            wave_lengths(self.mix["new_tokens"], self.batch))
        out = []
        for n in lengths:
            out.append(Request(self._next, self._items_of_one(), int(n)))
            self._next += 1
        return out

    @staticmethod
    def prompt(pool: np.ndarray, items: np.ndarray) -> np.ndarray:
        """The prompt that a request's items make, from a copy of the
        pool."""
        return pool[items].reshape(-1)
