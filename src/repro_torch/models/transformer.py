"""Decoder-only transformer: the dense and MoE families (GQA/MQA, qk-norm,
GeGLU/SwiGLU/squared-ReLU MLPs, MLA attention for deepseek-v2, the MoE
FFN of `models/moe.py` for dbrx and deepseek-v2), the counterpart of
`repro/models/transformer.py`.

The stacked layer params (layer axis first) are walked with a Python loop
over the leading axis in place of `lax.scan`. Weights stay in the param
dtype and are cast to the compute dtype at each use, as in the reference.
MLA's prefill expands the latent to per-head keys and values and takes the
plain attention path whatever `attn_impl` says (the reference passes it no
`impl`, and its value head dim differs from its key's); its decode scores
in the latent space. `loss_fn` is what the train step
(`train/trainer.py`) differentiates; with `cfg.remat`, each layer runs
under activation checkpointing while grad is enabled, as the reference
wraps its scan body in `jax.checkpoint`.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.context import MeshCtx
from repro_torch.models.moe import moe_ffn
from repro_torch.models.params import pdef


# ---------------------------------------------------------------------------
# Parameter definitions

def _attn_defs(cfg: ModelConfig, n: int) -> Dict[str, Any]:
    d = cfg.d_model
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "w_dq": pdef((n, d, m.q_lora_rank), (None, "fsdp", None)),
            "q_ln": pdef((n, m.q_lora_rank), (None, None), "ones"),
            "w_uq": pdef((n, m.q_lora_rank, cfg.n_heads, qk_dim),
                         (None, None, "heads", None)),
            "w_dkv": pdef((n, d, m.kv_lora_rank), (None, "fsdp", None)),
            "kv_ln": pdef((n, m.kv_lora_rank), (None, None), "ones"),
            "w_kr": pdef((n, d, m.qk_rope_head_dim), (None, "fsdp", None)),
            "w_uk": pdef((n, m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim),
                         (None, None, "heads", None)),
            "w_uv": pdef((n, m.kv_lora_rank, cfg.n_heads, m.v_head_dim),
                         (None, None, "heads", None)),
            "w_o": pdef((n, cfg.n_heads, m.v_head_dim, d),
                        (None, "heads", None, "fsdp")),
        }
    out: Dict[str, Any] = {
        "w_q": pdef((n, d, cfg.n_heads, cfg.head_dim), (None, "fsdp", "heads", None)),
        "w_k": pdef((n, d, cfg.n_kv_heads, cfg.head_dim), (None, "fsdp", "kv_heads", None)),
        "w_v": pdef((n, d, cfg.n_kv_heads, cfg.head_dim), (None, "fsdp", "kv_heads", None)),
        "w_o": pdef((n, cfg.n_heads, cfg.head_dim, d), (None, "heads", None, "fsdp")),
    }
    if cfg.qk_norm:
        out["q_norm"] = pdef((n, cfg.head_dim), (None, None), "ones")
        out["k_norm"] = pdef((n, cfg.head_dim), (None, None), "ones")
    return out


def _mlp_defs(cfg: ModelConfig, n: int,
              d_ff: Optional[int] = None) -> Dict[str, Any]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act in ("swiglu", "geglu"):
        return {
            "w_gate": pdef((n, d, f), (None, "fsdp", "mlp")),
            "w_up": pdef((n, d, f), (None, "fsdp", "mlp")),
            "w_down": pdef((n, f, d), (None, "mlp", "fsdp")),
        }
    return {
        "w_in": pdef((n, d, f), (None, "fsdp", "mlp")),
        "w_out": pdef((n, f, d), (None, "mlp", "fsdp")),
    }


def _moe_defs(cfg: ModelConfig, n: int) -> Dict[str, Any]:
    mc = cfg.moe
    d, f, e = cfg.d_model, mc.d_ff_expert, mc.n_experts
    defs: Dict[str, Any] = {
        "router": pdef((n, d, e), (None, None, None), scale=0.02),
    }
    if cfg.act in ("swiglu", "geglu"):
        defs["experts"] = {
            "w_gate": pdef((n, e, d, f), (None, "experts", "fsdp", None)),
            "w_up": pdef((n, e, d, f), (None, "experts", "fsdp", None)),
            "w_down": pdef((n, e, f, d), (None, "experts", "fsdp", None)),
        }
    else:
        defs["experts"] = {
            "w_in": pdef((n, e, d, f), (None, "experts", "fsdp", None)),
            "w_out": pdef((n, e, f, d), (None, "experts", "fsdp", None)),
        }
    if mc.n_shared:
        defs["shared"] = _mlp_defs(cfg, n, d_ff=mc.n_shared * f)
    return defs


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    n, d = cfg.n_layers, cfg.d_model
    block: Dict[str, Any] = {
        "ln_attn": pdef((n, d), (None, None), "ones"),
        "ln_mlp": pdef((n, d), (None, None), "ones"),
        "attn": _attn_defs(cfg, n),
        "mlp": _moe_defs(cfg, n) if cfg.family == "moe" else _mlp_defs(cfg, n),
    }
    defs = {
        "embed": pdef((cfg.vocab, d), ("vocab", "fsdp"), "embed"),
        "ln_f": pdef((d,), (None,), "ones"),
        "blocks": block,
    }
    if not cfg.tie_embeddings:
        defs["unembed"] = pdef((d, cfg.vocab), ("fsdp", "vocab"), "embed")
    return defs


def _layer(tree: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of a stacked param or cache tree (views, no copies)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Attention forward (dense GQA), train/prefill and decode variants

def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("btd,dhk->bthk", x, w) with w cast to x's dtype."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k).to(x.dtype)).unflatten(-1, (h, k))


def _gqa(x, p, cfg: ModelConfig, positions, *, cache=None, pos=None,
         window=None):
    """x (B,T,D). Train/prefill when cache is None; decode otherwise.

    cache: dict(k=(B,S,KH,Dh), v=(B,S,KH,Dh)); pos: (B,) write positions.
    Decode writes k, v into the cache in place (the reference donates the
    cache across decode steps). Returns (out, new_cache_or_None).
    """
    cdt = x.dtype
    q = _proj(x, p["w_q"])
    k = _proj(x, p["w_k"])
    v = _proj(x, p["w_v"])
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.rms_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.rms_eps)
    cos, sin = L.rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    if cache is None:
        out = L.attention(q, k, v,
                          q_positions=positions, kv_positions=positions,
                          causal=True, window=window, impl=cfg.attn_impl)
        new_cache = {"k": k, "v": v}
    else:
        B = x.shape[0]
        ck, cv = cache["k"], cache["v"]
        rows = torch.arange(B, device=x.device)
        ck[rows, pos] = k[:, 0].to(ck.dtype)
        cv[rows, pos] = v[:, 0].to(cv.dtype)
        S = ck.shape[1]
        out = L.attention(q, ck.to(cdt), cv.to(cdt),
                          q_positions=torch.zeros((1,), dtype=torch.int32,
                                                  device=x.device),
                          kv_positions=torch.arange(S, device=x.device),
                          causal=False, window=None, kv_len=pos + 1,
                          chunk=S)
        new_cache = {"k": ck, "v": cv}
    H, hd, d = p["w_o"].shape
    out = out.reshape(*out.shape[:2], H * hd) @ p["w_o"].reshape(
        H * hd, d).to(cdt)
    return out, new_cache


def _mla(x, p, cfg: ModelConfig, positions, *, cache=None, pos=None):
    """Multi-head Latent Attention. The cache keeps only the latent (ckv)
    and the shared rotary key (krope).

    Prefill/train: per-head k and v expanded from the latent (the naive
    path), through the plain attention. Decode: the weight-absorbed path,
    scores and values in the latent space, scores in float32. Decode
    writes into the cache in place, as `_gqa` does."""
    m = cfg.mla
    cdt = x.dtype
    B, T, _ = x.shape
    H = cfg.n_heads
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(nope + rope)

    cq = L.rms_norm(x @ p["w_dq"].to(cdt), p["q_ln"], cfg.rms_eps)
    q = _proj(cq, p["w_uq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = L.rms_norm(x @ p["w_dkv"].to(cdt), p["kv_ln"], cfg.rms_eps)
    krope = x @ p["w_kr"].to(cdt)

    cos, sin = L.rope_freqs(positions, rope, cfg.rope_theta)
    q_rope = L.apply_rope(q_rope, cos, sin)
    krope = L.apply_rope(krope[:, :, None, :], cos, sin)[:, :, 0, :]

    if cache is None:
        k_nope = _proj(ckv, p["w_uk"])
        val = _proj(ckv, p["w_uv"])
        k_full = torch.cat([k_nope, krope[:, :, None, :].expand(B, T, H, rope)],
                           dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        out = L.attention(q_full, k_full, val,
                          q_positions=positions, kv_positions=positions,
                          causal=True, softmax_scale=scale)
        new_cache = {"ckv": ckv, "krope": krope}
    else:
        ckv_c, kr_c = cache["ckv"], cache["krope"]
        rows = torch.arange(B, device=x.device)
        ckv_c[rows, pos] = ckv[:, 0].to(ckv_c.dtype)
        kr_c[rows, pos] = krope[:, 0].to(kr_c.dtype)
        ckv_d = ckv_c.to(cdt)
        # q' = q_nope . W_uk: the query in the latent space
        q_lat = torch.einsum("bthn,khn->bthk", q_nope, p["w_uk"].to(cdt))
        # products of the compute dtype summed in float32 (the reference's
        # preferred_element_type)
        s = (torch.einsum("bthk,bsk->bhts", q_lat.float(), ckv_d.float())
             + torch.einsum("bthr,bsr->bhts", q_rope.float(),
                            kr_c.to(cdt).float())) * scale
        S = ckv_c.shape[1]
        valid = (torch.arange(S, device=x.device)[None, :]
                 < (pos + 1)[:, None])                              # (B,S)
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), -1e30, dtype=s.dtype, device=s.device))
        w = torch.softmax(s, dim=-1).to(cdt)
        ctx = torch.einsum("bhts,bsk->bthk", w, ckv_d)
        out = torch.einsum("bthk,khv->bthv", ctx, p["w_uv"].to(cdt))
        new_cache = {"ckv": ckv_c, "krope": kr_c}
    Hv, hv, d = p["w_o"].shape
    out = out.reshape(B, T, Hv * hv) @ p["w_o"].reshape(Hv * hv, d).to(cdt)
    return out, new_cache


# ---------------------------------------------------------------------------
# Block + full forward

def _ffn(x, p, cfg: ModelConfig, mctx: MeshCtx):
    if cfg.family == "moe":
        return moe_ffn(x, p, cfg, mctx)
    cdt = x.dtype
    return L.mlp(x, {k: v.to(cdt) for k, v in p.items()}, cfg.act)


def _block(x, bp, cfg: ModelConfig, mctx: MeshCtx, positions,
           cache=None, pos=None):
    h = L.rms_norm(x, bp["ln_attn"], cfg.rms_eps)
    if cfg.mla is not None:
        a, new_cache = _mla(h, bp["attn"], cfg, positions, cache=cache, pos=pos)
    else:
        a, new_cache = _gqa(h, bp["attn"], cfg, positions, cache=cache, pos=pos)
    x = x + a
    h = L.rms_norm(x, bp["ln_mlp"], cfg.rms_eps)
    x = x + _ffn(h, bp["mlp"], cfg, mctx)
    if mctx is not None:
        x = mctx.constraint(x, mctx.batch_spec(None, None))
    return x, new_cache


def _embed_in(params, tokens, cfg: ModelConfig):
    cdt = getattr(torch, cfg.compute_dtype)
    # gather, then cast: the same values as the reference's cast-then-gather
    x = params["embed"][tokens.long()].to(cdt)
    if cfg.name.startswith("gemma") or cfg.family == "hybrid":
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)
    return x


def _unembed(params, x, cfg: ModelConfig):
    cdt = x.dtype
    if cfg.tie_embeddings:
        return x @ params["embed"].to(cdt).T
    return x @ params["unembed"].to(cdt)


def forward(params, tokens, cfg: ModelConfig, mctx: MeshCtx,
            collect_cache: bool = False):
    """tokens (B,T) -> logits (B,T,V) [+ stacked kv cache]."""
    x = _embed_in(params, tokens, cfg)
    T = tokens.shape[1]
    positions = torch.arange(T, device=x.device)
    # cfg.remat: each layer keeps only its input for the backward and runs
    # again there (the reference's jax.checkpoint with nothing_saveable).
    # On one device remat_policy="save_collectives" keeps nothing more than
    # "nothing": the tensors it would keep are the outputs of the
    # tensor-parallel all-reduces, which a single device never runs, so
    # keeping them would spare the recompute no collective.
    remat = cfg.remat and torch.is_grad_enabled()
    caches = []
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        if remat:
            x, c = checkpoint(_block, x, bp, cfg, mctx, positions,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            x, c = _block(x, bp, cfg, mctx, positions)
        if collect_cache:
            caches.append(c)
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    logits = _unembed(params, x, cfg)
    if mctx is not None:
        logits = mctx.constraint(logits, mctx.batch_spec(None, "model"))
    if not collect_cache:
        return logits
    return logits, {key: torch.stack([c[key] for c in caches])
                    for key in caches[0]}


def loss_fn(params, batch, cfg: ModelConfig, mctx: MeshCtx):
    logits = forward(params, batch["tokens"], cfg, mctx)
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"))


# ---------------------------------------------------------------------------
# Serving

class CacheSpec(NamedTuple):
    """Shape and dtype of one cache tensor (no allocation)."""
    shape: tuple
    dtype: torch.dtype


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None):
    """Specs of the stacked decode cache: (L, B, S, KH, Dh) keys and
    values, or MLA's latent (L, B, S, kv_lora_rank) and rotary key (L, B,
    S, qk_rope_head_dim)."""
    if dtype is None:
        dtype = getattr(torch, cfg.kv_cache_dtype)
    n = cfg.n_layers
    if cfg.mla is not None:
        m = cfg.mla
        return {"ckv": CacheSpec((n, batch, max_len, m.kv_lora_rank), dtype),
                "krope": CacheSpec((n, batch, max_len, m.qk_rope_head_dim),
                                   dtype)}
    shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": CacheSpec(shape, dtype), "v": CacheSpec(shape, dtype)}


def prefill(params, tokens, cfg: ModelConfig, mctx: MeshCtx):
    """Returns (last-token logits (B,V), stacked cache (L,...))."""
    logits, caches = forward(params, tokens, cfg, mctx, collect_cache=True)
    return logits[:, -1], caches


def decode_step(params, token, pos, cache, cfg: ModelConfig, mctx: MeshCtx):
    """token (B,), pos (B,) -> (logits (B,V), stacked cache).

    The cache is updated in place and returned."""
    x = _embed_in(params, token[:, None], cfg)
    for i in range(cfg.n_layers):
        x, _ = _block(x, _layer(params["blocks"], i), cfg, mctx,
                      pos[:, None], cache=_layer(cache, i), pos=pos)
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    logits = _unembed(params, x, cfg)[:, 0]
    return logits, cache
