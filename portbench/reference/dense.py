"""Plain float32 reference of the dense decoder block the benchmark serves
(granite-3-2b): RMSNorm, rotary GQA attention under a causal mask, a
SwiGLU MLP, tied or untied logits.

It reads its sizes from a configuration file's published keys
(`DenseShape.from_config`) and its weights from the benchmark's weight
tree (`portbench/weights.py` documents the layout). It imports nothing of
the program: it is the model written out again, one request at a time,
with no cache, no batching and no kernel. Every product goes through
`mm`, so that the control (`portbench/control.py`) can run the same
mathematics in a lower precision.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

Matmul = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 (TF32 is switched off by `float32_matmuls`)."""
    return a.float() @ b.float()


def float32_matmuls() -> None:
    """No TF32 in the reference's float32 products on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclass(frozen=True)
class DenseShape:
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    eps: float
    rope_theta: float
    tied: bool
    attention_scale: float

    @classmethod
    def from_config(cls, c: dict) -> "DenseShape":
        """From a granite-style configuration (Hugging Face keys)."""
        head_dim = c.get("head_dim") or c["hidden_size"] // c[
            "num_attention_heads"]
        return cls(layers=c["num_hidden_layers"], d_model=c["hidden_size"],
                   heads=c["num_attention_heads"],
                   kv_heads=c["num_key_value_heads"], head_dim=head_dim,
                   d_ff=c["intermediate_size"], vocab=c["vocab_size"],
                   eps=c["rms_norm_eps"], rope_theta=c["rope_theta"],
                   tied=c["tie_word_embeddings"],
                   attention_scale=c["attention_multiplier"])


SHAPE = DenseShape          # what a configuration file's sizes are read into


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (T, H, D) at positions 0..T-1: the two halves
    of each head rotated by the angle pos * theta^(-2i/D)."""
    T, _, D = x.shape
    inv = theta ** (-torch.arange(0, D, 2, dtype=torch.float64,
                                  device=x.device) / D)
    ang = torch.arange(T, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(h: torch.Tensor, p: dict, s, mm: Matmul) -> torch.Tensor:
    """Causal GQA self-attention of h (T, d); query head i reads kv head
    i // (heads / kv_heads)."""
    T = h.shape[0]
    d, H, KH, D = s.d_model, s.heads, s.kv_heads, s.head_dim
    q = mm(h, p["w_q"].reshape(d, H * D)).reshape(T, H, D)
    k = mm(h, p["w_k"].reshape(d, KH * D)).reshape(T, KH, D)
    v = mm(h, p["w_v"].reshape(d, KH * D)).reshape(T, KH, D)
    q, k = rope(q, s.rope_theta), rope(k, s.rope_theta)
    g = H // KH
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    mask = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    out = torch.empty(T, H, D, dtype=torch.float32, device=h.device)
    for i in range(H):                  # a head at a time: (T, T) scores
        sc = mm(q[:, i], k[:, i].T) * s.attention_scale
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, i] = mm(torch.softmax(sc, dim=-1), v[:, i])
    return mm(out.reshape(T, H * D), p["w_o"].reshape(H * D, d))


def swiglu(h: torch.Tensor, p: dict, mm: Matmul) -> torch.Tensor:
    g = mm(h, p["w_gate"])
    return mm(torch.nn.functional.silu(g) * mm(h, p["w_up"]), p["w_down"])


def layer(tree: dict, i: int) -> dict:
    """Layer i's weights of a stacked tree (views)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def logits_at(x: torch.Tensor, w: dict, s, first: int,
              mm: Matmul) -> torch.Tensor:
    """Final norm and logits of positions first.. of x (T, d)."""
    h = rms_norm(x[first:], w["ln_f"], s.eps)
    head = w["embed"].T if s.tied else w["unembed"]
    return mm(h, head)


def forward(w: dict, s: DenseShape, tokens: torch.Tensor, first: int,
            mm: Matmul = mm_f32, ffn=None) -> torch.Tensor:
    """Logits (T - first, vocab) of one sequence `tokens` (T,) at positions
    first..T-1, in float32: the whole sequence through every layer, a
    layer at a time. `ffn(h, layer weights, mm)` is the block's
    feed-forward half (the dense MLP unless a caller gives another)."""
    ffn = ffn or swiglu
    x = w["embed"][tokens.long()].float()
    for i in range(s.layers):
        p = layer(w["blocks"], i)
        x = x + attention(rms_norm(x, p["ln_attn"], s.eps), p["attn"], s, mm)
        x = x + ffn(rms_norm(x, p["ln_mlp"], s.eps), p["mlp"], mm)
    return logits_at(x, w, s, first, mm)


def served_gaps(ref_logits: torch.Tensor, served: torch.Tensor,
                pick: Optional[torch.Tensor] = None) -> torch.Tensor:
    """At each position: how far the logit of the served token (or of
    `pick`, the token another computation would put first) lies below the
    reference's best, in units of that position's logits' standard
    deviation."""
    tok = served if pick is None else pick
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, tok.long()[:, None])[:, 0]
    return (best - got) / ref_logits.std(-1)
