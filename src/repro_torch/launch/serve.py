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

The model, its params and the client run on the CUDA card; there is no
CPU run of `main`. Library callers pass `device="cpu"` to the ModelAPI,
the context and the client (the tests do).
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import get_config
from repro_torch.core.client import ROS2Client
from repro_torch.launch.mesh import make_host_mesh_ctx
from repro_torch.models.api import ModelAPI
from repro_torch.models.params import init_params

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
    the device of `mctx`. `prefill_s` and `decode_s` add up the host wall
    time of each phase (each ends in a device-to-host read of the tokens,
    which waits for the card)."""

    def __init__(self, api: ModelAPI, params, mctx, batch: int,
                 prompt_len: int, max_seq: int):
        self.api, self.params, self.mctx = api, params, mctx
        self.batch, self.prompt_len, self.max_seq = batch, prompt_len, max_seq
        self.steps = 0
        self.slot_steps = 0
        self.active_slot_steps = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0

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

    def run_wave(self, reqs: List[Request]) -> None:
        n = len(reqs)
        if not 0 < n <= self.batch:
            raise ValueError(f"a wave takes 1..{self.batch} requests, got {n}")
        # pad the wave to full batch with clones of the last request
        padded = reqs + [reqs[-1]] * (self.batch - n)
        with torch.inference_mode():
            t0 = time.perf_counter()
            toks = torch.from_numpy(np.stack([r.prompt for r in padded]))
            logits, cache = self.api.prefill(self.params, {"tokens": toks},
                                             self.mctx)
            cache = self._pad_cache(cache)
            cur = logits.argmax(-1).to(torch.int32)
            pos = torch.full((self.batch,), self.prompt_len,
                             dtype=torch.int32, device=cur.device)
            first = cur.tolist()
            self.prefill_s += time.perf_counter() - t0
            for i, r in enumerate(reqs):
                r.out.append(first[i])
            t0 = time.perf_counter()
            while not all(r.done for r in reqs):
                logits, cache = self.api.decode(
                    self.params, {"token": cur, "pos": pos}, cache, self.mctx)
                cur = logits.argmax(-1).to(torch.int32)
                pos = pos + 1
                step = cur.tolist()
                self.steps += 1
                self.slot_steps += self.batch
                for i, r in enumerate(reqs):
                    if not r.done:
                        r.out.append(step[i])
                        self.active_slot_steps += 1
            self.decode_s += time.perf_counter() - t0


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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    client = ROS2Client(mode=args.storage_mode, transport=args.transport)
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
