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

On a mesh each rank computes on its params' local shards
(`models/params.py` `local_params`), as XLA partitions the reference's
specs; whether a leaf is sharded is read off its local shape against the
config's. Attention is column-parallel over the heads its spec shards
(`w_q`, and `w_k`, `w_v` where the kv heads divide the model ranks; where
they do not, every rank projects all kv heads and takes those its q heads
use), `w_o` row-parallel, its partial outputs summed over "model"; where
the heads do not divide, attention is replicated and nothing is summed.
MLA shards `w_uq`, `w_uk`, `w_uv` and `w_o` over heads and keeps its
latent projections whole. The MLP is column-, then row-parallel
(`layers.sharded_mlp`). The embedding is vocab-parallel (each rank looks
up the tokens of its vocab block, zeros the rest, and the ranks' rows
are summed), the logits stay vocab-sharded into a vocab-parallel loss,
and prefill and decode gather the last logits whole. Replicated weights
whose gradient is each rank's part (qk-norms and kv projections shared by
heads on several ranks) take it summed over "model" (`copy_to_model`).
fsdp leaves are gathered over "data" inside the layer (inside the
checkpointed block, so remat gathers them again), and a decode step
writes and reads the local kv heads of its cache. With remat_policy=
"save_collectives" a layer's attention and FFN are checkpointed apart,
each up to its output's collective over "model", which runs outside, so
the backward's recompute skips it as the reference's policy does.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.context import (MeshCtx, copy_to_model,
                                        gather_fsdp, gather_from_model,
                                        reduce_from_model)
from repro_torch.models.moe import moe_ffn, moe_sum
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


def _kv_heads(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig, hl: int,
              mctx: MeshCtx):
    """k, v (B, S, KH, Dh) with every kv head, cut to those this rank's
    `hl` q heads use: a slice where they form even groups, else one kv
    head per q head."""
    g = cfg.n_heads // cfg.n_kv_heads
    h0 = mctx.coordinate("model") * hl
    idx = [(h0 + j) // g for j in range(hl)]
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if hl % n == 0 and idx == [lo + j // (hl // n) for j in range(hl)]:
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    # made on the device: a host copy would break a CUDA graph's capture
    sel = torch.div(torch.arange(h0, h0 + hl, device=k.device), g,
                    rounding_mode="floor")
    return k.index_select(2, sel), v.index_select(2, sel)


def _heads_over_model(p, cfg: ModelConfig) -> bool:
    """Whether this rank's attention params (a layer's local shard) hold
    a share of the q heads, i.e. its output is a partial sum over
    "model"."""
    return (p["w_uq"] if cfg.mla is not None else p["w_q"]).shape[1] < \
        cfg.n_heads


def _gqa(x, p, cfg: ModelConfig, positions, mctx: MeshCtx = None, *,
         cache=None, pos=None, window=None, reduce=True):
    """x (B,T,D). Train/prefill when cache is None; decode otherwise.

    cache: dict(k=(B,S,KH,Dh), v=(B,S,KH,Dh)); pos: (B,) write positions.
    Decode writes k, v into the cache in place (the reference donates the
    cache across decode steps) and attends with cfg.attn_impl, as prefill
    does: "flash" sends a bf16 cache to the decode kernel. Returns (out, new_cache_or_None). On a
    mesh p is the layer's local shard and the cache holds the kv heads
    its spec gives this rank; with `reduce` False, out is left as this
    rank's partial sum over "model" (`_attn_sum`)."""
    cdt = x.dtype
    d = cfg.d_model
    w_q, w_k, w_v = (gather_fsdp(p[k], 0, mctx, d)
                     for k in ("w_q", "w_k", "w_v"))
    hl, khl = w_q.shape[1], w_k.shape[1]
    q_norm, k_norm = p.get("q_norm"), p.get("k_norm")
    heads = _heads_over_model(p, cfg)
    if heads:
        x = copy_to_model(x, mctx)
        if cfg.qk_norm:
            q_norm, k_norm = (copy_to_model(w, mctx) for w in (q_norm,
                                                               k_norm))
        if khl == cfg.n_kv_heads:      # kv heads whole: shared by ranks
            w_k, w_v = copy_to_model(w_k, mctx), copy_to_model(w_v, mctx)
    q = _proj(x, w_q)
    k = _proj(x, w_k)
    v = _proj(x, w_v)
    if cfg.qk_norm:
        q = L.rms_norm(q, q_norm, cfg.rms_eps)
        k = L.rms_norm(k, k_norm, cfg.rms_eps)
    cos, sin = L.rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    if cache is None:
        ka, va = (_kv_heads(k, v, cfg, hl, mctx)
                  if heads and khl == cfg.n_kv_heads else (k, v))
        out = L.attention(q, ka, va,
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
        ka, va = ck.to(cdt), cv.to(cdt)
        if heads and ck.shape[2] == cfg.n_kv_heads:
            ka, va = _kv_heads(ka, va, cfg, hl, mctx)
        out = L.attention(q, ka, va,
                          q_positions=torch.zeros((1,), dtype=torch.int32,
                                                  device=x.device),
                          kv_positions=torch.arange(S, device=x.device),
                          causal=False, window=None, kv_len=pos + 1,
                          chunk=S, impl=cfg.attn_impl)
        new_cache = {"k": ck, "v": cv}
    w_o = gather_fsdp(p["w_o"], 2, mctx, d)
    H, hd, _ = w_o.shape
    out = out.reshape(*out.shape[:2], H * hd) @ w_o.reshape(
        H * hd, d).to(cdt)
    return (reduce_from_model(out, mctx) if heads and reduce
            else out), new_cache


def _mla(x, p, cfg: ModelConfig, positions, mctx: MeshCtx = None, *,
         cache=None, pos=None, reduce=True):
    """Multi-Head Latent Attention. The cache keeps only the latent (ckv)
    and the shared rotary key (krope).

    Prefill/train: per-head k and v expanded from the latent (the naive
    path), through the plain attention. Decode: the weight-absorbed path,
    scores and values in the latent space, scores in float32. Decode
    writes into the cache in place, as `_gqa` does. On a mesh the latent
    projections are computed whole on every rank and the heads
    (`w_uq`, `w_uk`, `w_uv`, `w_o`) are this rank's; `reduce` as in
    `_gqa`."""
    m = cfg.mla
    cdt = x.dtype
    B, T, d = x.shape
    nope, rope = m.qk_nope_head_dim, m.qk_rope_head_dim
    scale = 1.0 / math.sqrt(nope + rope)
    w_dq, w_dkv, w_kr = (gather_fsdp(p[k], 0, mctx, d)
                         for k in ("w_dq", "w_dkv", "w_kr"))
    H = p["w_uq"].shape[1]             # this rank's heads
    heads = _heads_over_model(p, cfg)

    cq = L.rms_norm(x @ w_dq.to(cdt), p["q_ln"], cfg.rms_eps)
    ckv = L.rms_norm(x @ w_dkv.to(cdt), p["kv_ln"], cfg.rms_eps)
    krope = x @ w_kr.to(cdt)
    if heads:
        # the whole latents feed this rank's heads: their gradients are
        # the ranks' parts
        cq, ckv_h, krope = (copy_to_model(t, mctx) for t in (cq, ckv, krope))
    else:
        ckv_h = ckv
    q = _proj(cq, p["w_uq"])
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    cos, sin = L.rope_freqs(positions, rope, cfg.rope_theta)
    q_rope = L.apply_rope(q_rope, cos, sin)
    krope = L.apply_rope(krope[:, :, None, :], cos, sin)[:, :, 0, :]

    if cache is None:
        k_nope = _proj(ckv_h, p["w_uk"])
        val = _proj(ckv_h, p["w_uv"])
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
    w_o = gather_fsdp(p["w_o"], 2, mctx, d)
    Hv, hv, _ = w_o.shape
    out = out.reshape(B, T, Hv * hv) @ w_o.reshape(Hv * hv, d).to(cdt)
    return (reduce_from_model(out, mctx) if heads and reduce
            else out), new_cache


# ---------------------------------------------------------------------------
# Block + full forward

def _ffn(x, p, cfg: ModelConfig, mctx: MeshCtx, reduce: bool = True):
    if cfg.family == "moe":
        return moe_ffn(x, p, cfg, mctx, reduce)
    return L.sharded_mlp(x, p, cfg.act, cfg.d_ff, mctx, reduce)


def _block(x, bp, cfg: ModelConfig, mctx: MeshCtx, positions,
           cache=None, pos=None):
    h = L.rms_norm(x, bp["ln_attn"], cfg.rms_eps)
    if cfg.mla is not None:
        a, new_cache = _mla(h, bp["attn"], cfg, positions, mctx, cache=cache,
                            pos=pos)
    else:
        a, new_cache = _gqa(h, bp["attn"], cfg, positions, mctx, cache=cache,
                            pos=pos)
    x = x + a
    h = L.rms_norm(x, bp["ln_mlp"], cfg.rms_eps)
    x = x + _ffn(h, bp["mlp"], cfg, mctx)
    if mctx is not None:
        x = mctx.constraint(x, mctx.batch_spec(None, None))
    return x, new_cache


# remat_policy="save_collectives": the reference names the attention's
# and the FFN's outputs after their collectives ("attn_out", "ffn_out")
# and keeps them (jax.checkpoint with save_only_these_names), so that the
# backward's recompute runs none of the all-reduces after w_o and w_down
# nor the MoE output's all-gather. Here each of the two is checkpointed
# up to its partial output and its collective runs outside: a collective's
# backward (`reduce_from_model`'s identity, `gather_from_model`'s slice)
# keeps nothing, so what a layer keeps is the two pieces' inputs, the
# layer's input and its input plus the attention's output.

def _attn_partial(x, bp, cfg: ModelConfig, mctx: MeshCtx, positions):
    h = L.rms_norm(x, bp["ln_attn"], cfg.rms_eps)
    attn = _mla if cfg.mla is not None else _gqa
    return attn(h, bp["attn"], cfg, positions, mctx, reduce=False)


def _attn_sum(a, p, cfg: ModelConfig, mctx: MeshCtx):
    return reduce_from_model(a, mctx) if _heads_over_model(p, cfg) else a


def _ffn_partial(x, bp, cfg: ModelConfig, mctx: MeshCtx):
    return _ffn(L.rms_norm(x, bp["ln_mlp"], cfg.rms_eps), bp["mlp"], cfg,
                mctx, reduce=False)


def _ffn_sum(f, p, cfg: ModelConfig, mctx: MeshCtx, shape):
    if cfg.family == "moe":
        return moe_sum(f, p, cfg, mctx, shape)
    return L.mlp_sum(f, p, cfg.d_ff, mctx)


def _checkpointed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _block_saving_collectives(x, bp, cfg: ModelConfig, mctx: MeshCtx,
                              positions):
    """`_block` (train and prefill) under remat with "save_collectives"."""
    a, new_cache = _checkpointed(_attn_partial, x, bp, cfg, mctx, positions)
    x = x + _attn_sum(a, bp["attn"], cfg, mctx)
    f = _checkpointed(_ffn_partial, x, bp, cfg, mctx)
    x = x + _ffn_sum(f, bp["mlp"], cfg, mctx, x.shape)
    if mctx is not None:
        x = mctx.constraint(x, mctx.batch_spec(None, None))
    return x, new_cache


def _embed_in(params, tokens, cfg: ModelConfig, mctx: MeshCtx = None):
    """The tokens' embedding rows in the compute dtype. On a mesh, where
    the vocab is over "model", each rank looks up the tokens of its block,
    zeros the others, and the ranks' rows are summed."""
    cdt = getattr(torch, cfg.compute_dtype)
    emb = gather_fsdp(params["embed"], 1, mctx, cfg.d_model)
    vl = emb.shape[0]
    if vl < cfg.vocab:
        t = tokens.long() - mctx.coordinate("model") * vl
        inside = (t >= 0) & (t < vl)
        rows = emb[torch.where(inside, t, 0)].to(cdt)
        x = reduce_from_model(torch.where(inside[..., None], rows,
                                          torch.zeros((), dtype=cdt,
                                                      device=rows.device)),
                              mctx)
    else:
        # gather, then cast: the same values as the reference's
        # cast-then-gather
        x = emb[tokens.long()].to(cdt)
    if cfg.name.startswith("gemma") or cfg.family == "hybrid":
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt)
    return x


def _unembed(params, x, cfg: ModelConfig, mctx: MeshCtx = None):
    """Logits, through `unembed` or, where the params have none, the tied
    embedding; on a mesh with the vocab over "model", this rank's block of
    them."""
    cdt = x.dtype
    if "unembed" not in params:
        w = gather_fsdp(params["embed"], 1, mctx, cfg.d_model)
        if w.shape[0] < cfg.vocab:
            x = copy_to_model(x, mctx)
        return x @ w.to(cdt).T
    w = gather_fsdp(params["unembed"], 0, mctx, cfg.d_model)
    if w.shape[1] < cfg.vocab:
        x = copy_to_model(x, mctx)
    return x @ w.to(cdt)


def _whole_logits(logits, cfg: ModelConfig, mctx: MeshCtx):
    """Logits whole along the vocab (gathered where they are sharded)."""
    if logits.shape[-1] < cfg.vocab:
        return gather_from_model(logits, logits.dim() - 1, mctx)
    return logits


def forward(params, tokens, cfg: ModelConfig, mctx: MeshCtx,
            collect_cache: bool = False):
    """tokens (B,T) -> logits (B,T,V) [+ stacked kv cache]; on a mesh
    with the vocab over "model", this rank's block of the logits."""
    x = _embed_in(params, tokens, cfg, mctx)
    T = tokens.shape[1]
    positions = torch.arange(T, device=x.device)
    # cfg.remat: each layer keeps only its input for the backward and runs
    # again there (the reference's jax.checkpoint with nothing_saveable)
    # up to the inputs of its last product, which is as far as torch's
    # checkpoint recomputes: its fsdp gathers and its attention's
    # all-reduce included. With remat_policy="save_collectives" it keeps
    # what the reference keeps, and the recompute runs no collective of
    # "model" but the MoE's exchanges (`_block_saving_collectives`).
    remat = cfg.remat and torch.is_grad_enabled()
    caches = []
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        if remat and cfg.remat_policy == "save_collectives":
            x, c = _block_saving_collectives(x, bp, cfg, mctx, positions)
        elif remat:
            x, c = _checkpointed(_block, x, bp, cfg, mctx, positions)
        else:
            x, c = _block(x, bp, cfg, mctx, positions)
        if collect_cache:
            caches.append(c)
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    logits = _unembed(params, x, cfg, mctx)
    if mctx is not None:
        logits = mctx.constraint(logits, mctx.batch_spec(None, "model"))
    if not collect_cache:
        return logits
    return logits, {key: torch.stack([c[key] for c in caches])
                    for key in caches[0]}


def loss_fn(params, batch, cfg: ModelConfig, mctx: MeshCtx):
    logits = forward(params, batch["tokens"], cfg, mctx)
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"),
                          mctx if logits.shape[-1] < cfg.vocab else None)


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
    return _whole_logits(logits[:, -1], cfg, mctx), caches


def decode_step(params, token, pos, cache, cfg: ModelConfig, mctx: MeshCtx):
    """token (B,), pos (B,) -> (logits (B,V), stacked cache).

    The cache is updated in place and returned."""
    x = _embed_in(params, token[:, None], cfg, mctx)
    for i in range(cfg.n_layers):
        x, _ = _block(x, _layer(params["blocks"], i), cfg, mctx,
                      pos[:, None], cache=_layer(cache, i), pos=pos)
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    logits = _unembed(params, x, cfg, mctx)[:, 0]
    return _whole_logits(logits, cfg, mctx), cache
