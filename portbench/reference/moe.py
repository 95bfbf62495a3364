"""Plain float32 reference of the mixture-of-experts block the benchmark
serves (dbrx-132b cut in depth): the dense reference's attention
(`dense.attention`) and a token-choice top-k expert layer, dropless.

The router's logits and softmax are float32; each token takes the top_k
experts by probability, the lower index first among equals, and their
probabilities renormalised to sum to one (`moe_normalize_expert_weights`
= 1). Each expert is a SwiGLU MLP of width `ffn_hidden_size`. Every
assignment is computed: the published model drops none. It imports
nothing of the program.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from portbench.reference import dense


@dataclass(frozen=True)
class MoEShape(dense.DenseShape):
    experts: int = 0
    top_k: int = 0
    d_expert: int = 0

    @classmethod
    def from_config(cls, c: dict) -> "MoEShape":
        """From a dbrx-style configuration (Hugging Face keys)."""
        a, f = c["attn_config"], c["ffn_config"]
        d, H = c["d_model"], c["n_heads"]
        return cls(layers=c["n_layers"], d_model=d, heads=H,
                   kv_heads=a["kv_n_heads"], head_dim=d // H,
                   d_ff=f["ffn_hidden_size"], vocab=c["vocab_size"],
                   eps=c["rms_norm_eps"], rope_theta=a["rope_theta"],
                   tied=c["tie_word_embeddings"],
                   attention_scale=(d // H) ** -0.5,
                   experts=f["moe_num_experts"], top_k=f["moe_top_k"],
                   d_expert=f["ffn_hidden_size"])


SHAPE = MoEShape


def route(h: torch.Tensor, router: torch.Tensor, top_k: int):
    """(gates (T, k), experts (T, k)) of h (T, d): float32 softmax, top k
    by a stable descending sort, renormalised."""
    probs = torch.softmax(h.float() @ router.float(), dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :top_k], idx[:, :top_k]
    return gates / gates.sum(-1, keepdim=True), idx


def moe_ffn(h: torch.Tensor, p: dict, s: MoEShape,
            mm: dense.Matmul) -> torch.Tensor:
    """The expert layer on h (T, d): each expert runs on the tokens routed
    to it, its output added with the token's gate."""
    gates, idx = route(h, p["router"], s.top_k)
    out = torch.zeros_like(h, dtype=torch.float32)
    ex = p["experts"]
    for e in range(s.experts):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = dense.swiglu(h[tok], {k: v[e] for k, v in ex.items()}, mm)
        out.index_add_(0, tok, y * gates[tok, slot][:, None])
    return out


def forward(w: dict, s: MoEShape, tokens: torch.Tensor, first: int,
            mm: dense.Matmul = dense.mm_f32) -> torch.Tensor:
    """Logits (T - first, vocab) of one sequence, as `dense.forward`, with
    the expert layer as each block's feed-forward half."""
    return dense.forward(w, s, tokens, first, mm,
                         ffn=lambda h, p, m: moe_ffn(h, p, s, m))
