"""Whether what the timed path produced is right, by the plain reference.

The numbers, each compared with its limit in the cell's file:

- store_mismatches: requests of the window whose prompt, as the store
  returned it to the program, differs from the prompt the benchmark
  assembles from its own copy of the pool (limit 0: every byte read is
  the byte written);
- over a sample of the window's requests, drawn from the seed and
  holding the one with the most served tokens, the gap by which each
  served token's logit lies below the reference's best at its position,
  in units of the standard deviation of the reference's logits there:
  served_gap_sigma, the widest, and served_gap_mean_sigma, the mean.
  The reference runs once over each sampled prompt followed by its
  served tokens: the first served token checks the prefill, the rest the
  decode steps through the program's cache. A cell's file names the ones
  it is held to: the widest gap where it separates the program from the
  control; where a discrete choice inside the model (an expert's routing)
  flips under bfloat16's rounding and sets the widest gap alone, the
  mean.

The control (`served_gap`'s `control_...` values) puts the reference in
the program's place in a lower precision: at each position of the same
prompts and tokens, the token the lower precision puts first, read by
the same gaps.
"""
from __future__ import annotations

import importlib
from typing import Callable, List

import numpy as np

from portbench.traffic import SAMPLE, rng_for


def reference(config: dict):
    """(shape, forward) of the configuration's plain reference module
    (`portbench/reference/<config["reference"]>.py`). Published keys that
    the program does not model (`not_modelled`) are read as it runs them
    (`runs_as`)."""
    mod = importlib.import_module(f"portbench.reference.{config['reference']}")
    return (mod.SHAPE.from_config({**config, **config.get("runs_as", {})}),
            mod.forward)


def store_mismatches(reqs: List[dict], traffic, pool: np.ndarray) -> int:
    bad = 0
    for r in reqs:
        want = traffic.prompt(pool, r["items"])
        bad += int("prompt" not in r or not np.array_equal(r["prompt"], want))
    return bad


def sample(reqs: List[dict], n: int, seed: int) -> List[dict]:
    """n served requests drawn from the seed, the longest among them."""
    done = [r for r in reqs if "out" in r]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r["out"]), -r["rid"]))
    rest = [r for r in done if r is not longest]
    pick = rng_for(seed, SAMPLE).permutation(len(rest))[:max(n - 1, 0)]
    return [longest] + [rest[i] for i in sorted(pick)]


def _sequence(r: dict, traffic, pool: np.ndarray):
    import torch
    prompt = traffic.prompt(pool, r["items"])
    served = np.asarray(r["out"], dtype=np.int64)
    return (torch.from_numpy(np.concatenate([prompt, served[:-1]])),
            torch.from_numpy(served), len(prompt))


def served_gap(picked: List[dict], traffic, pool, weights, config: dict,
               device, control: Callable = None) -> dict:
    """Over the sampled requests' served tokens, each token's gap (in
    sigma): their widest (`served_gap_sigma`), their mean
    (`served_gap_mean_sigma`) and the share that is not the reference's
    first choice (`served_mismatch_share`). With `control` (a matmul of
    lower precision), the same three of the tokens that the reference
    computed in that precision puts first (`control_...`)."""
    import torch

    from portbench.reference.dense import float32_matmuls, served_gaps
    float32_matmuls()
    shape, forward = reference(config)
    prog, ctrl = [], []
    with torch.inference_mode():
        for r in picked:
            seq, served, p = _sequence(r, traffic, pool)
            if served.min() < 0 or served.max() >= shape.vocab:
                prog.append(torch.full((len(served),), float("inf")))
                continue                        # a token past the vocab
            seq, served = seq.to(device), served.to(device)
            ref = forward(weights, shape, seq, p - 1)
            prog.append(served_gaps(ref, served).cpu())
            if control is not None:
                low = forward(weights, shape, seq, p - 1, mm=control)
                ctrl.append(served_gaps(ref, served, low.argmax(-1)).cpu())
            del ref
    out = {"sampled_requests": len(picked)}
    for name, gaps in (("served", prog), ("control", ctrl)):
        if not gaps:
            continue
        g = torch.cat(gaps).double()
        out[f"{name}_gap_sigma"] = float(g.max())
        out[f"{name}_gap_mean_sigma"] = float(g.mean())
        out[f"{name}_mismatch_share"] = float((g > 0).double().mean())
    out["sampled_tokens"] = int(sum(len(g) for g in prog))
    return out


def judge(values: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) for every limit."""
    rows = [(k, values[k], limits[k]) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
