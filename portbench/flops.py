"""The benchmark's frozen operation counts: a model step's FLOPs and the
attention bound. They read sizes from the reference's shapes
(`reference/dense.py` `DenseShape`, `reference/moe.py` `MoEShape`), never
from the program.

A token's forward costs 2 FLOPs per multiply-add of every weight it
passes through: per layer the attention's projections (d * H * hd for
q, 2 * d * KH * hd for k and v, H * hd * d for the output) and the
feed-forward half (3 * d * f for a SwiGLU MLP; for a mixture of
experts the router, d * E, and top_k experts of 3 * d * f), plus the
head (d * V) where the token's logits are used; the embedding is a
lookup and costs nothing. Attention adds 4 * hd * H FLOPs per (query,
key) pair that the causal mask keeps: 2 * hd for q.k and 2 * hd for p.v.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())


def weight_macs_per_token(s) -> int:
    """Multiply-adds of one token through every layer (head excluded)."""
    d, H, KH, hd = s.d_model, s.heads, s.kv_heads, s.head_dim
    attn = d * H * hd + 2 * d * KH * hd + H * hd * d
    if getattr(s, "experts", 0):
        ffn = d * s.experts + s.top_k * 3 * d * s.d_expert
    else:
        ffn = 3 * d * s.d_ff
    return s.layers * (attn + ffn)


def causal_pairs(first: int, n: int) -> int:
    """(query, key) pairs of queries at positions first..first+n-1, each
    over the keys at or before it."""
    return n * first + n * (n + 1) // 2


def forward_flops(s, first: int, n: int, heads_out: int) -> int:
    """FLOPs of n tokens at positions first.. of one sequence (the keys
    before `first` already cached), `heads_out` of which have their
    logits used."""
    return (2 * n * weight_macs_per_token(s)
            + 2 * heads_out * s.d_model * s.vocab
            + 4 * s.head_dim * s.heads * s.layers * causal_pairs(first, n))


def prefill_flops(s, batch: int, prompt: int) -> int:
    """A prefill wave: each sequence's prompt, its last logits used."""
    return batch * forward_flops(s, 0, prompt, 1)


def decode_flops(s, position: int) -> int:
    """One decode token at `position` (its key included)."""
    return forward_flops(s, position, 1, 1)


def attention_bound_s(B: int, T: int, H: int, KH: int, D: int,
                      elem: int = 2) -> dict:
    """The least time an H100 could take for causal self-attention of
    (B, T, H, D) queries over (B, T, KH, D) keys and values: the larger
    of its FLOPs (4 * D a kept pair) over the bf16 peak and its bytes
    (q, k, v and the output once in `elem`-byte elements, the float32
    log-sum-exp once) over HBM's rate."""
    flops = 4 * D * B * H * causal_pairs(0, T)
    nbytes = (2 * B * T * H * D + 2 * B * T * KH * D) * elem + 4 * B * H * T
    ops_s = flops / PEAKS["bf16_flops"]
    bytes_s = nbytes / PEAKS["hbm_bytes_per_s"]
    return {"flops": flops, "bytes": nbytes, "bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}
