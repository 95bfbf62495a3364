"""Batched serving: prompts stream out of the ROS2 object store,
responses decode with iteration-level batching.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch tiny-granite-3-2b --requests 16 --batch 4 \
        --prompt-len 32 --max-new 16 --storage-mode dpu --transport rdma

Scheduling: requests queue up; waves of up to --batch requests prefill
together and decode in lockstep; a request exits at its stop length, and
the wave ends when all its slots are done (iteration-level batching — the
KV cache is updated in place across decode steps). Tokens/s and per-wave
occupancy are reported; prompt bytes arrive through the same DFS client
the trainer uses (host or DPU-offloaded, TCP or RDMA).

Prefill and decode are compiled steps, as the reference jits both
(`train/trainer.py` `StaticStep`): on the card each is captured once per
engine into a CUDA graph (the two share one memory pool) and a wave is one
prefill replay, then one decode replay a step plus the host read of its
tokens. The decode graph holds the greedy pick and the position's
increment, and prefill's cache lands in the decode step's max_seq cache,
made once. On the CPU the same steps run eagerly on the same buffers.
`compiled=()` runs both eagerly, op by op.

The model, its params and the client run on the CUDA card; `main` takes
`--device cpu` for a CPU run (the examples' tests use it). Library callers
pass `device="cpu"` to the ModelAPI, the context and the client.
"""
from __future__ import annotations

import argparse
import time
import weakref
from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core.client import ROS2Client
from repro_torch.launch.mesh import make_host_mesh_ctx
from repro_torch.models.api import ModelAPI
from repro_torch.models.params import init_params
from repro_torch.train.trainer import BIND, LIKE, StaticStep, map_tree

TOKEN_BYTES = 4
# the sequence axis of each family's self-attention caches: (L,B,S,KH,D)
# keys and values (dense, moe, encdec), MLA's (L,B,S,r) latent and
# (L,B,S,rope) rotary key, the vlm's (n_super,k,B,S,KH,D)
SEQ_AXIS = {"dense": 2, "moe": 2, "encdec": 2, "vlm": 3}


def grow_seq(x: torch.Tensor, axis: int, n: int) -> torch.Tensor:
    """x with n zero positions appended on `axis`."""
    return F.pad(x, [0, 0] * (x.dim() - 1 - axis) + [0, n])


def grow_cache(cache: dict, family: str, n: int) -> dict:
    """A prefill cache with n zero positions appended to its
    self-attention caches, by position. The vlm's and encdec's caches
    keep them under "self"; their cross caches keep their length. Hybrid
    and ssm state is O(1) in the sequence and passes through unchanged."""
    if family not in SEQ_AXIS:
        return cache
    axis = SEQ_AXIS[family]
    if family in ("vlm", "encdec"):
        return dict(cache, self={k: grow_seq(x, axis, n)
                                 for k, x in cache["self"].items()})
    return {k: grow_seq(x, axis, n) for k, x in cache.items()}


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new


def write_prompts(client, n: int, prompt_len: int, vocab: int,
                  seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    client.mkdir("/prompts")
    for i in range(n):
        toks = rng.integers(0, vocab, prompt_len, dtype=np.int32)
        fd = client.open(f"/prompts/req-{i:04d}", create=True)
        client.pwrite(fd, toks.tobytes(), 0)


def read_prompt(client, rid: int, prompt_len: int) -> np.ndarray:
    fd = client.open(f"/prompts/req-{rid:04d}")
    raw = client.pread(fd, prompt_len * TOKEN_BYTES, 0)
    return np.frombuffer(raw, np.int32)


class BatchedEngine:
    """Wave-scheduled batched prefill+decode over a fixed slot count, on
    the device of `mctx`. `compiled` names the steps that run as compiled
    steps (captured CUDA graphs on the card); the others run eagerly.
    `prefill_s` and `decode_s` add up the host wall time of each phase
    (each ends in a device-to-host read of the tokens, which waits for the
    card)."""

    def __init__(self, api: ModelAPI, params, mctx, batch: int,
                 prompt_len: int, max_seq: int,
                 compiled: Tuple[str, ...] = ("prefill", "decode")):
        self.api, self.params, self.mctx = api, params, mctx
        self.batch, self.prompt_len, self.max_seq = batch, prompt_len, max_seq
        if not set(compiled) <= {"prefill", "decode"}:
            raise ValueError(f"compiled names prefill and decode, got "
                             f"{compiled}")
        self.compiled = tuple(compiled)
        self.steps = 0
        self.slot_steps = 0
        self.active_slot_steps = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        # the decode step's state, made by the first prefill: the next
        # token, its position and the max_seq cache; and the last logits
        # of each step
        self.token = self.pos = self.cache = None
        self.logits = {}
        pool = (torch.cuda.graph_pool_handle()
                if mctx.device.type == "cuda" else None)
        # the steps reach the engine weakly: an engine dropped frees its
        # params and graphs at once, not at the next garbage collection
        me = weakref.proxy(self)
        self.prefill_step = StaticStep(lambda *a: me._prefill(*a),
                                       mctx.device,
                                       {"params": BIND, "inputs": LIKE},
                                       pool)
        self.decode_step = StaticStep(lambda *a: me._decode(*a), mctx.device,
                                      {"params": BIND}, pool)

    def _pad_cache(self, cache):
        """Grow the self-attention caches' sequence axis from prompt_len to
        max_seq for decode (`grow_cache`). The reference pads the first
        axis whose size equals prompt_len, which is the layer axis when
        prompt_len == n_layers; the port pads by position. Hybrid and ssm
        state passes through unchanged, as in the reference. This
        engine's waves prefill the tokens alone, so they serve no vlm or
        encdec model (nor do the reference's): those take inputs besides
        the tokens."""
        return grow_cache(cache, self.api.cfg.family,
                          self.max_seq - self.prompt_len)

    def _land(self, cache) -> None:
        """A prefill cache written into the decode state as `_pad_cache`
        would grow it: the first prompt_len positions, zeros after."""
        grown = self.max_seq - self.prompt_len
        if self.cache is None:          # the first (eager) call makes it
            self.cache = self._pad_cache(cache)
            return

        def land(dst, src):
            if dst.shape == src.shape:
                dst.copy_(src)
                return
            axis = next(i for i, (a, b) in enumerate(zip(dst.shape,
                                                         src.shape))
                        if a != b)
            dst.narrow(axis, 0, self.prompt_len).copy_(src)
            dst.narrow(axis, self.prompt_len, grown).zero_()
        map_tree(land, self.cache, cache)

    def _prefill(self, params, inputs):
        """Prefill, its cache landed in the decode state, the first greedy
        tokens and their positions; returns the logits."""
        logits, cache = self.api.prefill(params, inputs, self.mctx)
        self._land(cache)
        if self.token is None:
            self.token = logits.argmax(-1).to(torch.int32)
            self.pos = torch.full((self.batch,), self.prompt_len,
                                  dtype=torch.int32, device=logits.device)
        else:
            self.token.copy_(logits.argmax(-1))
            self.pos.fill_(self.prompt_len)
        return logits

    def _decode(self, params):
        """One decode step on the decode state, in place: the cache, the
        next greedy token and its position; returns the logits."""
        logits, _ = self.api.decode(params, {"token": self.token,
                                             "pos": self.pos}, self.cache,
                                    self.mctx)
        self.token.copy_(logits.argmax(-1))
        self.pos.add_(1)
        return logits

    def _run_prefill(self, inputs) -> None:
        step = (self.prefill_step if "prefill" in self.compiled
                else self._prefill)
        self.logits["prefill"] = step(self.params, inputs)

    def _run_decode(self) -> None:
        step = self.decode_step if "decode" in self.compiled else self._decode
        self.logits["decode"] = step(self.params)

    def run_wave(self, reqs: List[Request]) -> None:
        n = len(reqs)
        if not 0 < n <= self.batch:
            raise ValueError(f"a wave takes 1..{self.batch} requests, got {n}")
        # pad the wave to full batch with clones of the last request
        padded = reqs + [reqs[-1]] * (self.batch - n)
        with torch.inference_mode():
            t0 = time.perf_counter()
            toks = torch.from_numpy(np.stack([r.prompt for r in padded]))
            self._run_prefill(self.wave_inputs(padded, toks))
            first = self.token.tolist()
            self.prefill_s += time.perf_counter() - t0
            for i, r in enumerate(reqs):
                r.out.append(first[i])
            t0 = time.perf_counter()
            while not all(r.done for r in reqs):
                self._run_decode()
                step = self.token.tolist()
                self.steps += 1
                self.slot_steps += self.batch
                for i, r in enumerate(reqs):
                    if not r.done:
                        r.out.append(step[i])
                        self.active_slot_steps += 1
            self.decode_s += time.perf_counter() - t0

    def wave_inputs(self, padded: List[Request], toks: torch.Tensor) -> dict:
        """The prefill inputs of a wave: its tokens. An engine for the vlm
        or encdec family adds their other inputs here."""
        return {"tokens": toks}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-granite-3-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--storage-mode", choices=("host", "dpu"), default="dpu")
    ap.add_argument("--transport", choices=("tcp", "rdma"), default="rdma")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model runs: the CUDA card by default, "
                         "or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    api = ModelAPI(cfg, device=args.device)
    mctx = make_host_mesh_ctx(cfg, device=args.device)
    client = ROS2Client(mode=args.storage_mode, transport=args.transport,
                        device=args.device)
    write_prompts(client, args.requests, args.prompt_len, cfg.vocab,
                  args.seed)
    gen = torch.Generator(device=mctx.device).manual_seed(args.seed)
    params = init_params(api.param_defs(), gen,
                         getattr(torch, cfg.param_dtype), mctx.device)
    max_seq = args.prompt_len + args.max_new + 8
    eng = BatchedEngine(api, params, mctx, args.batch, args.prompt_len,
                        max_seq)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, read_prompt(client, i, args.prompt_len),
                    int(rng.integers(args.max_new // 2, args.max_new + 1)))
            for i in range(args.requests)]
    t0 = time.perf_counter()
    waves = 0
    for i in range(0, len(reqs), args.batch):
        eng.run_wave(reqs[i:i + args.batch])
        waves += 1
    wall = time.perf_counter() - t0
    new_tokens = sum(len(r.out) for r in reqs)
    occ = eng.active_slot_steps / max(eng.slot_steps, 1)
    print(f"[serve] {len(reqs)} requests in {waves} waves: "
          f"{new_tokens} new tokens, {new_tokens / wall:,.1f} tok/s, "
          f"slot occupancy {100 * occ:.0f}%")
    if client.dpu:
        print(f"[serve] DPU ops processed: {client.dpu.ops_processed}")
    client.close()
    if not all(r.done for r in reqs):
        raise RuntimeError("a request did not finish")
    return new_tokens / wall


if __name__ == "__main__":
    main()
