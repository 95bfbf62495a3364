"""The model's weights, made by the benchmark on the device from the seed
and handed to the program and to the reference alike.

The tree is the program's parameter layout, leaves in float32 (the type
the program serves them in; it computes in bfloat16):

    embed (V, d); ln_f (d,); unembed (d, V) where not tied
    blocks: ln_attn, ln_mlp (L, d)
            attn: w_q (L, d, H, hd), w_k, w_v (L, d, KH, hd),
                  w_o (L, H, hd, d)
            mlp:  w_gate, w_up (L, d, f), w_down (L, f, d)
               or router (L, d, E), experts: w_gate, w_up (L, E, d, f),
                  w_down (L, E, f, d)

Each leaf is one draw from a torch.Generator on the device, in sorted
key order: the norms are ones, the embedding and the unembedding are
normal with std 0.02, the router normal with std 0.02, every other
weight normal with std 1/sqrt(fan-in), the fan-in being the dims that
the product sums over: d for w_q, w_k, w_v, w_gate and w_up, H * hd for
w_o, f for w_down (an expert's own d or f for the experts). A fan-in
read off the last-but-one dim instead (the head count of w_q, 1 for
a single kv head) draws scores with a std of tens and a softmax that is
an argmax, and a model whose logits a rounding of its weights to
bfloat16 alone decorrelates within eight layers.
"""
from __future__ import annotations

import math

import torch

EMBED_STD = 0.02
ROUTER_STD = 0.02


def fan_in(path: tuple, shape: tuple) -> int:
    """The summed-over size of a stacked leaf (layer axis first)."""
    if "experts" in path:                   # (L, E, in, out)
        return shape[2]
    if path[-1] == "w_o":                   # (L, H, hd, d)
        return shape[1] * shape[2]
    return shape[1]                         # (L, in, ...)


def _std(path: tuple, shape: tuple) -> float:
    if path[-1] in ("embed", "unembed"):
        return EMBED_STD
    if path[-1] == "router":
        return ROUTER_STD
    return 1.0 / math.sqrt(fan_in(path, shape))


def make_weights(shapes: dict, seed: int, device) -> dict:
    """A tree of float32 leaves of `shapes` (a nested dict whose leaves
    are shape tuples) drawn from `seed` on `device`."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def build(node: dict, path: tuple) -> dict:
        out = {}
        for key in sorted(node):
            sub = node[key]
            if isinstance(sub, dict):
                out[key] = build(sub, path + (key,))
            elif key.startswith("ln_"):
                out[key] = torch.ones(sub, dtype=torch.float32,
                                      device=device)
            else:
                out[key] = torch.randn(sub, generator=gen,
                                       dtype=torch.float32,
                                       device=device).mul_(
                    _std(path + (key,), sub))
        return out
    return build(shapes, ())


def shapes_of(defs) -> dict:
    """The shape tree of a program's parameter definitions (objects with a
    `.shape`)."""
    return {k: shapes_of(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in defs.items()}
