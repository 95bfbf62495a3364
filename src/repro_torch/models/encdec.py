"""Whisper-style encoder-decoder backbone (the audio family), the
counterpart of `repro/models/encdec.py`.

The conv frontend is a stub, as in the reference: the caller supplies
precomputed frame embeddings (B, n_frames, d_model). Sinusoidal positions,
pre-LayerNorm, GELU MLPs with biases. The decoder has causal
self-attention and cross-attention to the encoder output. Every attention
takes the plain path (the reference passes `L.attention` no `impl`), so
the family reaches no kernel. The stacked `enc` and `dec` layer params are
walked by Python loops in place of `lax.scan`; decode writes the self
caches in place and returns the cache.

On a mesh each rank computes on its params' local shards, as XLA
partitions the reference's specs. Attention takes its q heads over
"model" where they divide the model ranks (the kv heads too where they
do; where they do not, each rank projects them whole and takes those its
q heads use) and is row-parallel out, summed over "model"; where the
heads do not divide it runs replicated. The MLP is column-parallel in
(`w_in`, `b_in`) and row-parallel out (`w_out`), its `b_out` added once,
after the sum. The embedding and the tied logits are vocab-parallel
where the vocab divides, else replicated. fsdp leaves are gathered over
"data" inside the layer, and the caches hold the kv heads each rank's
spec gives it.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.context import (MeshCtx, copy_to_model, gather_fsdp,
                                        reduce_from_model)
from repro_torch.models.params import pdef
from repro_torch.models.transformer import (CacheSpec, _embed_in, _kv_heads,
                                            _layer, _proj, _unembed,
                                            _whole_logits)


def _attn_defs(cfg, n):
    d = cfg.d_model
    return {
        "w_q": pdef((n, d, cfg.n_heads, cfg.head_dim), (None, "fsdp", "heads", None)),
        "w_k": pdef((n, d, cfg.n_kv_heads, cfg.head_dim), (None, "fsdp", "kv_heads", None)),
        "w_v": pdef((n, d, cfg.n_kv_heads, cfg.head_dim), (None, "fsdp", "kv_heads", None)),
        "w_o": pdef((n, cfg.n_heads, cfg.head_dim, d), (None, "heads", None, "fsdp")),
    }


def _mlp_defs(cfg, n):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_in": pdef((n, d, f), (None, "fsdp", "mlp")),
        "b_in": pdef((n, f), (None, "mlp"), "zeros"),
        "w_out": pdef((n, f, d), (None, "mlp", "fsdp")),
        "b_out": pdef((n, d), (None, None), "zeros"),
    }


def _ln(n, d, name):
    return {f"{name}_w": pdef((n, d), (None, None), "ones"),
            f"{name}_b": pdef((n, d), (None, None), "zeros")}


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    ne = cfg.encdec.n_enc_layers
    nd = cfg.n_layers
    d = cfg.d_model
    enc = {"attn": _attn_defs(cfg, ne), "mlp": _mlp_defs(cfg, ne),
           **_ln(ne, d, "ln1"), **_ln(ne, d, "ln2")}
    dec = {"self_attn": _attn_defs(cfg, nd), "cross_attn": _attn_defs(cfg, nd),
           "mlp": _mlp_defs(cfg, nd),
           **_ln(nd, d, "ln1"), **_ln(nd, d, "ln2"), **_ln(nd, d, "ln3")}
    return {
        "embed": pdef((cfg.vocab, d), ("vocab", "fsdp"), "embed"),
        "enc": enc,
        "dec": dec,
        "ln_enc_w": pdef((d,), (None,), "ones"),
        "ln_enc_b": pdef((d,), (None,), "zeros"),
        "ln_dec_w": pdef((d,), (None,), "ones"),
        "ln_dec_b": pdef((d,), (None,), "zeros"),
    }


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The (..., d) sinusoid table of `positions`, float32. It is computed
    in float64 and rounded once, so that every device gives the same table
    (a float32 exp or sin differs between the CPU and the card by an ulp,
    which a position near 1,500 turns into 1e-4); the reference's float32
    table is off the exact one by up to 1.2e-4 there."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float64, device=positions.device) / max(half - 1, 1))
    ang = positions.double()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).float()


def _mha(x, p, cfg: ModelConfig, mctx: MeshCtx = None, positions=None,
         kv=None, causal=True, cache=None, pos=None):
    """Self- or cross-attention. kv: the cross layer's keys and values,
    the kv heads this rank's spec gives it."""
    cdt = x.dtype
    d = cfg.d_model
    w_q = gather_fsdp(p["w_q"], 0, mctx, d)
    hl = w_q.shape[1]
    heads = hl < cfg.n_heads           # q heads over "model"
    if heads:
        x = copy_to_model(x, mctx)
    q = _proj(x, w_q)

    def used(k, v):
        """k, v cut to the kv heads this rank's q heads use, where every
        rank holds them all."""
        if heads and k.shape[2] == cfg.n_kv_heads:
            return _kv_heads(k, v, cfg, hl, mctx)
        return k, v
    new_cache = None
    if kv is not None:                       # cross: precomputed k/v
        out = L.cross_attention(q, *used(*kv))
    else:
        w_k, w_v = (gather_fsdp(p[k], 0, mctx, d) for k in ("w_k", "w_v"))
        if heads and w_k.shape[1] == cfg.n_kv_heads:
            # kv heads whole: shared by ranks
            w_k, w_v = copy_to_model(w_k, mctx), copy_to_model(w_v, mctx)
        k, v = _proj(x, w_k), _proj(x, w_v)
        if cache is None:                    # self-attention (train/prefill)
            out = L.attention(q, *used(k, v), q_positions=positions,
                              kv_positions=positions, causal=causal)
            new_cache = {"k": k, "v": v}
        else:                                # decode
            B = x.shape[0]
            ck, cv = cache["k"], cache["v"]
            rows = torch.arange(B, device=x.device)
            ck[rows, pos] = k[:, 0].to(ck.dtype)
            cv[rows, pos] = v[:, 0].to(cv.dtype)
            S = ck.shape[1]
            out = L.attention(q, *used(ck.to(cdt), cv.to(cdt)),
                              q_positions=torch.zeros((1,), dtype=torch.int32,
                                                      device=x.device),
                              kv_positions=torch.arange(S, device=x.device),
                              causal=False, kv_len=pos + 1, chunk=S)
            new_cache = {"k": ck, "v": cv}
    w_o = gather_fsdp(p["w_o"], 2, mctx, d)
    H, hd, _ = w_o.shape
    out = out.reshape(*out.shape[:2], H * hd) @ w_o.reshape(H * hd, d).to(cdt)
    return (reduce_from_model(out, mctx) if heads else out), new_cache


def _cross_kv(enc_out, p, cfg: ModelConfig, mctx: MeshCtx = None):
    """A cross layer's k, v from the encoder output: the kv heads this
    rank's `w_k`, `w_v` hold."""
    d = cfg.d_model
    w_k, w_v = (gather_fsdp(p[k], 0, mctx, d) for k in ("w_k", "w_v"))
    if p["w_q"].shape[1] < cfg.n_heads:
        # the whole inputs feed this rank's heads: their gradients are
        # the ranks' parts
        enc_out = copy_to_model(enc_out, mctx)
        if w_k.shape[1] == cfg.n_kv_heads:
            w_k, w_v = copy_to_model(w_k, mctx), copy_to_model(w_v, mctx)
    return _proj(enc_out, w_k), _proj(enc_out, w_v)


def _mlp(x, p, cfg: ModelConfig, mctx: MeshCtx = None):
    """GELU MLP with biases: column-parallel in, row-parallel out where
    the hidden columns are over "model", `b_out` added once after the
    ranks' partial outputs are summed."""
    cdt = x.dtype
    d = cfg.d_model
    w_in = gather_fsdp(p["w_in"], 0, mctx, d)
    w_out = gather_fsdp(p["w_out"], 1, mctx, d)
    cols = w_in.shape[-1] < cfg.d_ff
    if cols:
        x = copy_to_model(x, mctx)
    h = F.gelu(x @ w_in.to(cdt) + p["b_in"].to(cdt), approximate="tanh")
    out = h @ w_out.to(cdt)
    if cols:
        out = reduce_from_model(out, mctx)
    return out + p["b_out"].to(cdt)


def _enc_block(h, bp, cfg, mctx, positions):
    a, _ = _mha(L.layer_norm(h, bp["ln1_w"], bp["ln1_b"]), bp["attn"], cfg,
                mctx, positions=positions, causal=False)
    h = h + a
    return h + _mlp(L.layer_norm(h, bp["ln2_w"], bp["ln2_b"]), bp["mlp"],
                    cfg, mctx)


def encode(params, frames, cfg: ModelConfig, mctx):
    """frames (B, F, D) stub embeddings -> encoder output (B, F, D)."""
    cdt = getattr(torch, cfg.compute_dtype)
    x = frames.to(cdt)
    n_frames = x.shape[1]
    positions = torch.arange(n_frames, device=x.device)
    x = x + _sinusoid(positions, cfg.d_model).to(cdt)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.encdec.n_enc_layers):
        bp = _layer(params["enc"], i)
        if remat:
            x = checkpoint(_enc_block, x, bp, cfg, mctx, positions,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _enc_block(x, bp, cfg, mctx, positions)
        if mctx is not None:
            x = mctx.constraint(x, mctx.batch_spec(None, None))
    return L.layer_norm(x, params["ln_enc_w"], params["ln_enc_b"])


def _dec_block(h, bp, cfg, mctx, positions, enc_out, c_self, c_cross, pos):
    cdt = h.dtype
    a, new_self = _mha(L.layer_norm(h, bp["ln1_w"], bp["ln1_b"]),
                       bp["self_attn"], cfg, mctx, positions=positions,
                       cache=c_self, pos=pos)
    h = h + a
    if c_cross is not None:
        kv = (c_cross["k"].to(cdt), c_cross["v"].to(cdt))
        new_cross = c_cross
    else:
        kv = _cross_kv(enc_out, bp["cross_attn"], cfg, mctx)
        new_cross = {"k": kv[0], "v": kv[1]}
    a, _ = _mha(L.layer_norm(h, bp["ln2_w"], bp["ln2_b"]), bp["cross_attn"],
                cfg, mctx, kv=kv)
    h = h + a
    h = h + _mlp(L.layer_norm(h, bp["ln3_w"], bp["ln3_b"]), bp["mlp"], cfg,
                 mctx)
    return h, {"self": new_self, "cross": new_cross}


def _decoder(params, tokens, enc_out, cfg, mctx, collect_cache=False,
             cache=None, pos=None):
    """The decoder over tokens (B,T): from the encoder output (train and
    prefill), or one step from the cache at positions `pos` (decode).
    Returns (logits (B,T,V), the stacked caches or None); on a mesh with
    the vocab over "model", this rank's block of the logits."""
    x = _embed_in(params, tokens, cfg, mctx)
    cdt = x.dtype
    T = tokens.shape[1]
    positions = torch.arange(T, device=x.device)
    x = x + _sinusoid(positions if pos is None else pos[:, None],
                      cfg.d_model).to(cdt)
    remat = cfg.remat and cache is None and torch.is_grad_enabled()
    caches = []
    for i in range(cfg.n_layers):
        bp = _layer(params["dec"], i)
        c_self = c_cross = None
        if cache is not None:
            c_self = _layer(cache["self"], i)
            c_cross = _layer(cache["cross"], i)
        if remat:
            x, c = checkpoint(_dec_block, x, bp, cfg, mctx, positions,
                              enc_out, None, None, None, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, c = _dec_block(x, bp, cfg, mctx, positions, enc_out, c_self,
                              c_cross, pos)
        if mctx is not None:
            x = mctx.constraint(x, mctx.batch_spec(None, None))
        caches.append(c)
    x = L.layer_norm(x, params["ln_dec_w"], params["ln_dec_b"])
    logits = _unembed(params, x, cfg, mctx)
    if mctx is not None:
        logits = mctx.constraint(logits, mctx.batch_spec(None, "model"))
    if cache is not None:
        return logits, cache
    if not collect_cache:
        return logits, None
    return logits, {
        group: {key: torch.stack([c[group][key] for c in caches])
                for key in ("k", "v")}
        for group in ("self", "cross")}


def loss_fn(params, batch, cfg, mctx):
    enc_out = encode(params, batch["frames"], cfg, mctx)
    logits, _ = _decoder(params, batch["tokens"], enc_out, cfg, mctx)
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"),
                          mctx if logits.shape[-1] < cfg.vocab else None)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int, n_frames: int,
               dtype: torch.dtype = torch.bfloat16):
    """Specs of the self caches (L, B, S, KH, Dh) and the cross caches (L,
    B, n_frames, KH, Dh)."""
    nd = cfg.n_layers
    kv = (cfg.n_kv_heads, cfg.head_dim)
    return {
        "self": {"k": CacheSpec((nd, batch, max_len) + kv, dtype),
                 "v": CacheSpec((nd, batch, max_len) + kv, dtype)},
        "cross": {"k": CacheSpec((nd, batch, n_frames) + kv, dtype),
                  "v": CacheSpec((nd, batch, n_frames) + kv, dtype)},
    }


def prefill(params, frames, tokens, cfg, mctx):
    """Encode, then a decoder pass collecting the caches. Returns
    (last-token logits (B,V), caches)."""
    enc_out = encode(params, frames, cfg, mctx)
    logits, caches = _decoder(params, tokens, enc_out, cfg, mctx,
                              collect_cache=True)
    return _whole_logits(logits[:, -1], cfg, mctx), caches


def decode_step(params, token, pos, cache, cfg, mctx):
    """token (B,), pos (B,) -> (logits (B,V), cache), the self caches
    updated in place."""
    logits, cache = _decoder(params, token[:, None], None, cfg, mctx,
                             cache=cache, pos=pos)
    return _whole_logits(logits[:, 0], cfg, mctx), cache
