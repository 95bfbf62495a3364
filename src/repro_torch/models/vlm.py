"""Llama-3.2-Vision-style VLM backbone, the counterpart of
`repro/models/vlm.py`: a self-attention decoder with interleaved gated
cross-attention layers over precomputed patch embeddings.

The vision frontend is a stub, as in the reference: the caller supplies
(B, n_vision_tokens, d_vision) patch embeddings, which a learned
projection maps into the text width. The layers come in super-blocks of
`cross_every - 1` self-attention layers and one gated cross-attention
layer (100 layers = 20 super-blocks for llama-3.2-vision-90b), stacked
`super.self` (n_super, k, ...) and `super.cross` (n_super, ...) and walked
by Python loops in place of `lax.scan`. The self layers are the dense
family's `_gqa`, so with attn_impl="flash" their prefill reaches the flash
kernel; the cross layers take the plain unmasked attention. The gates
start at zero, so at init tanh(0) removes the whole cross path. Decode
writes the self caches in place and returns the cache.

On a mesh each rank computes on its params' local shards, as XLA
partitions the reference's specs: the self layers through
`transformer._gqa` and `layers.sharded_mlp`, the cross layers with their
q heads over "model" (the kv heads too where they divide the model
ranks; where they do not, each rank projects them whole and takes those
its q heads use), `w_o` row-parallel and summed over "model" before the
gate's tanh scales it, and the cross MLP `sharded_mlp`. The embedding
and the logits (through the embedding: the params have no `unembed`)
are vocab-parallel; `vis_proj` and every fsdp leaf are gathered over
"data" inside the layer. The caches hold the kv heads each rank's spec
gives it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as tr
from repro_torch.models.context import (copy_to_model, gather_fsdp,
                                        reduce_from_model)
from repro_torch.models.params import pdef
from repro_torch.models.transformer import CacheSpec, _embed_in, _layer, _proj


def _cross_defs(cfg: ModelConfig, n: int) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "ln": pdef((n, d), (None, None), "ones"),
        "ln_mlp": pdef((n, d), (None, None), "ones"),
        "w_q": pdef((n, d, cfg.n_heads, cfg.head_dim), (None, "fsdp", "heads", None)),
        "w_k": pdef((n, d, cfg.n_kv_heads, cfg.head_dim), (None, "fsdp", "kv_heads", None)),
        "w_v": pdef((n, d, cfg.n_kv_heads, cfg.head_dim), (None, "fsdp", "kv_heads", None)),
        "w_o": pdef((n, cfg.n_heads, cfg.head_dim, d), (None, "heads", None, "fsdp")),
        "q_ln": pdef((n, cfg.head_dim), (None, None), "ones"),
        "k_ln": pdef((n, cfg.head_dim), (None, None), "ones"),
        "gate_attn": pdef((n,), (None,), "zeros"),
        "gate_mlp": pdef((n,), (None,), "zeros"),
        "mlp": tr._mlp_defs(cfg, n),
    }


def n_super(cfg: ModelConfig) -> int:
    if cfg.n_layers % cfg.vlm.cross_every:
        raise ValueError(f"{cfg.n_layers} layers are not a whole number of "
                         f"super-blocks of {cfg.vlm.cross_every}")
    return cfg.n_layers // cfg.vlm.cross_every


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    ns = n_super(cfg)
    k = cfg.vlm.cross_every - 1          # self layers per super-block
    d = cfg.d_model
    self_defs = {
        "ln_attn": pdef((ns, k, d), (None, None, None), "ones"),
        "ln_mlp": pdef((ns, k, d), (None, None, None), "ones"),
        "attn": {
            "w_q": pdef((ns, k, d, cfg.n_heads, cfg.head_dim),
                        (None, None, "fsdp", "heads", None)),
            "w_k": pdef((ns, k, d, cfg.n_kv_heads, cfg.head_dim),
                        (None, None, "fsdp", "kv_heads", None)),
            "w_v": pdef((ns, k, d, cfg.n_kv_heads, cfg.head_dim),
                        (None, None, "fsdp", "kv_heads", None)),
            "w_o": pdef((ns, k, cfg.n_heads, cfg.head_dim, d),
                        (None, None, "heads", None, "fsdp")),
        },
        "mlp": {
            "w_gate": pdef((ns, k, d, cfg.d_ff), (None, None, "fsdp", "mlp")),
            "w_up": pdef((ns, k, d, cfg.d_ff), (None, None, "fsdp", "mlp")),
            "w_down": pdef((ns, k, cfg.d_ff, d), (None, None, "mlp", "fsdp")),
        },
    }
    return {
        "embed": pdef((cfg.vocab, d), ("vocab", "fsdp"), "embed"),
        "vis_proj": pdef((cfg.vlm.d_vision, d), (None, "fsdp")),
        "ln_f": pdef((d,), (None,), "ones"),
        "super": {"self": self_defs, "cross": _cross_defs(cfg, ns)},
    }


def _self_block(x, bp, cfg, mctx, positions, cache=None, pos=None):
    h = L.rms_norm(x, bp["ln_attn"], cfg.rms_eps)
    a, new_cache = tr._gqa(h, bp["attn"], cfg, positions, mctx, cache=cache,
                           pos=pos)
    x = x + a
    h = L.rms_norm(x, bp["ln_mlp"], cfg.rms_eps)
    x = x + L.sharded_mlp(h, bp["mlp"], cfg.act, cfg.d_ff, mctx)
    if mctx is not None:
        x = mctx.constraint(x, mctx.batch_spec(None, None))
    return x, new_cache


def _q_heads(cp, cfg) -> bool:
    """Whether this rank's cross layer holds only some of the q heads."""
    return cp["w_q"].shape[1] < cfg.n_heads


def _cross_kv(vis, cp, cfg, mctx=None):
    """vis (B, N, D) projected patch embeddings -> this layer's k, v: the
    kv heads this rank's `w_k`, `w_v` hold."""
    d = cfg.d_model
    w_k, w_v = (gather_fsdp(cp[k], 0, mctx, d) for k in ("w_k", "w_v"))
    k_ln = cp["k_ln"]
    if _q_heads(cp, cfg):
        # the whole inputs feed this rank's heads: their gradients are
        # the ranks' parts
        vis, k_ln = copy_to_model(vis, mctx), copy_to_model(k_ln, mctx)
        if w_k.shape[1] == cfg.n_kv_heads:
            w_k, w_v = copy_to_model(w_k, mctx), copy_to_model(w_v, mctx)
    k = _proj(vis, w_k)
    v = _proj(vis, w_v)
    k = L.rms_norm(k, k_ln, cfg.rms_eps)
    return k, v


def _cross_block(x, cp, cfg, mctx, kv):
    cdt = x.dtype
    d = cfg.d_model
    k, v = kv
    h = L.rms_norm(x, cp["ln"], cfg.rms_eps)
    w_q = gather_fsdp(cp["w_q"], 0, mctx, d)
    q_ln = cp["q_ln"]
    heads = _q_heads(cp, cfg)
    if heads:
        h, q_ln = copy_to_model(h, mctx), copy_to_model(q_ln, mctx)
        if k.shape[2] == cfg.n_kv_heads:
            k, v = tr._kv_heads(k, v, cfg, w_q.shape[1], mctx)
    q = L.rms_norm(_proj(h, w_q), q_ln, cfg.rms_eps)
    a = L.cross_attention(q, k, v)
    w_o = gather_fsdp(cp["w_o"], 2, mctx, d)
    H, hd, _ = w_o.shape
    a = a.reshape(*a.shape[:2], H * hd) @ w_o.reshape(H * hd, d).to(cdt)
    if heads:
        a = reduce_from_model(a, mctx)
    x = x + torch.tanh(cp["gate_attn"]).to(cdt) * a
    h = L.rms_norm(x, cp["ln_mlp"], cfg.rms_eps)
    m = L.sharded_mlp(h, cp["mlp"], cfg.act, cfg.d_ff, mctx)
    x = x + torch.tanh(cp["gate_mlp"]).to(cdt) * m
    if mctx is not None:
        x = mctx.constraint(x, mctx.batch_spec(None, None))
    return x


def _super_block(x, sp, vis, cfg, mctx, positions, collect_cache):
    self_caches = []
    for j in range(cfg.vlm.cross_every - 1):
        x, c = _self_block(x, _layer(sp["self"], j), cfg, mctx, positions)
        self_caches.append(c)
    kv = _cross_kv(vis, sp["cross"], cfg, mctx)
    x = _cross_block(x, sp["cross"], cfg, mctx, kv)
    if not collect_cache:
        return x, None
    return x, {"self": {key: torch.stack([c[key] for c in self_caches])
                        for key in ("k", "v")},
               "cross": {"k": kv[0], "v": kv[1]}}


def forward(params, tokens, vision_embeds, cfg: ModelConfig, mctx,
            collect_cache=False):
    """tokens (B,T), vision_embeds (B,N,d_vision) -> logits (B,T,V) [+
    the stacked caches]; on a mesh with the vocab over "model", this
    rank's block of the logits."""
    x = _embed_in(params, tokens, cfg, mctx)
    cdt = x.dtype
    vis = vision_embeds.to(cdt) @ gather_fsdp(
        params["vis_proj"], 1, mctx, cfg.d_model).to(cdt)
    positions = torch.arange(tokens.shape[1], device=x.device)
    # cfg.remat: each super-block keeps only its input for the backward,
    # as the reference checkpoints its scan body with nothing_saveable
    remat = cfg.remat and torch.is_grad_enabled()
    caches = []
    for i in range(n_super(cfg)):
        sp = _layer(params["super"], i)
        if remat:
            x, c = checkpoint(_super_block, x, sp, vis, cfg, mctx, positions,
                              collect_cache, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, c = _super_block(x, sp, vis, cfg, mctx, positions,
                                collect_cache)
        caches.append(c)
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    logits = tr._unembed(params, x, cfg, mctx)
    if mctx is not None:
        logits = mctx.constraint(logits, mctx.batch_spec(None, "model"))
    if not collect_cache:
        return logits
    return logits, {
        group: {key: torch.stack([c[group][key] for c in caches])
                for key in ("k", "v")}
        for group in ("self", "cross")}


def loss_fn(params, batch, cfg, mctx):
    logits = forward(params, batch["tokens"], batch["vision_embeds"], cfg,
                     mctx)
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"),
                          mctx if logits.shape[-1] < cfg.vocab else None)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16):
    """Specs of the self caches (n_super, k, B, S, KH, Dh) and the cross
    caches (n_super, B, n_vision_tokens, KH, Dh)."""
    ns = n_super(cfg)
    k = cfg.vlm.cross_every - 1
    kv = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cross = (ns, batch, cfg.vlm.n_vision_tokens, cfg.n_kv_heads, cfg.head_dim)
    return {
        "self": {"k": CacheSpec((ns, k) + kv, dtype),
                 "v": CacheSpec((ns, k) + kv, dtype)},
        "cross": {"k": CacheSpec(cross, dtype), "v": CacheSpec(cross, dtype)},
    }


def prefill(params, tokens, vision_embeds, cfg, mctx):
    """Returns (last-token logits (B,V), the stacked caches)."""
    logits, caches = forward(params, tokens, vision_embeds, cfg, mctx,
                             collect_cache=True)
    return tr._whole_logits(logits[:, -1], cfg, mctx), caches


def decode_step(params, token, pos, cache, cfg, mctx):
    """token (B,), pos (B,) -> (logits (B,V), cache). The self caches are
    updated in place; the cross caches are read as they are."""
    x = _embed_in(params, token[:, None], cfg, mctx)
    cdt = x.dtype
    for i in range(n_super(cfg)):
        sp, c = _layer(params["super"], i), _layer(cache, i)
        for j in range(cfg.vlm.cross_every - 1):
            x, _ = _self_block(x, _layer(sp["self"], j), cfg, mctx,
                               pos[:, None], cache=_layer(c["self"], j),
                               pos=pos)
        kv = (c["cross"]["k"].to(cdt), c["cross"]["v"].to(cdt))
        x = _cross_block(x, sp["cross"], cfg, mctx, kv)
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return tr._whole_logits(tr._unembed(params, x, cfg, mctx)[:, 0], cfg,
                            mctx), cache
