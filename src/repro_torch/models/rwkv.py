"""RWKV6 ("Finch") — attention-free LM with data-dependent decay, the
counterpart of `repro/models/rwkv.py`.

Time-mix per head keeps a matrix state S (hd x hd):
    y_t = r_t @ (diag(u) k_t v_t^T + S_t)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T
with data-dependent per-channel decay w_t in (0,1).

Sequence forms: `wkv_sequential` (the oracle, O(T) steps) and
`wkv_chunked` (the chunk-parallel form, the plain path of prefill and
training); with attn_impl="flash" prefill runs the `wkv6` kernel instead.
A decode step (T = 1 with a state) takes `wkv_decode` and no kernel, as in
the reference. The stacked layer params and states keep the reference's
layout (layer axis first), walked by a Python loop in place of `lax.scan`;
decode updates the state in place and returns it.

On a mesh each rank computes on its params' local shards, as XLA
partitions the reference's specs. The time mix is column-parallel over
its `rnn` channels, a whole number of heads a rank (`w_r`, `w_k`, `w_v`,
`w_g`), runs the WKV and the per-head group norm on the local heads and
is row-parallel out (`w_o`, summed over "model"); the token-shift mixes
and the decay's LoRA are computed whole on every rank, and the
replicated per-channel params a rank uses only in part (`decay_w2`,
`decay_base`, `bonus`, `ln_x_w`, `ln_x_b`) take their gradient summed
over "model" (`copy_to_model`) before their local columns are cut. The
channel mix is column-, then row-parallel over `mlp` (`w_k`, `w_v`),
with its `w_r` gate computed whole. The WKV state holds the local heads;
the embedding and the tied logits are vocab-parallel. fsdp leaves are
gathered over "data" inside the layer.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.rwkv6_scan import ref as wkv_ref
from repro_torch.models import layers as L
from repro_torch.models import transformer as tr
from repro_torch.models.context import (MeshCtx, copy_to_model, gather_fsdp,
                                        reduce_from_model)
from repro_torch.models.params import pdef, tree_map
from repro_torch.models.transformer import CacheSpec, _layer

MIX_NAMES = ("r", "w", "k", "v", "g")


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    n, d = cfg.n_layers, cfg.d_model
    rw = cfg.rwkv
    hd = rw.head_dim
    h = d // hd
    la = (None,)
    block = {
        "ln1": pdef((n, d), la + (None,), "ones"),
        "ln1b": pdef((n, d), la + (None,), "zeros"),
        "ln2": pdef((n, d), la + (None,), "ones"),
        "ln2b": pdef((n, d), la + (None,), "zeros"),
        "tmix": {
            "mu_base": pdef((n, d), la + (None,), "zeros"),
            "mix_w1": pdef((n, d, 5 * rw.mix_lora), la + (None, None), scale=0.02),
            "mix_w2": pdef((n, 5, rw.mix_lora, d), la + (None, None, None), scale=0.02),
            "mu": pdef((n, 5, d), la + (None, None), "zeros"),
            "w_r": pdef((n, d, d), la + ("fsdp", "rnn")),
            "w_k": pdef((n, d, d), la + ("fsdp", "rnn")),
            "w_v": pdef((n, d, d), la + ("fsdp", "rnn")),
            "w_g": pdef((n, d, d), la + ("fsdp", "rnn")),
            "w_o": pdef((n, d, d), la + ("rnn", "fsdp")),
            "decay_base": pdef((n, d), la + (None,), "normal", scale=1.0),
            "decay_w1": pdef((n, d, rw.decay_lora), la + (None, None), scale=0.02),
            "decay_w2": pdef((n, rw.decay_lora, d), la + (None, None), scale=0.02),
            "bonus": pdef((n, h, hd), la + (None, None), "normal", scale=0.5),
            "ln_x_w": pdef((n, d), la + (None,), "ones"),
            "ln_x_b": pdef((n, d), la + (None,), "zeros"),
        },
        "cmix": {
            "mu_k": pdef((n, d), la + (None,), "zeros"),
            "mu_r": pdef((n, d), la + (None,), "zeros"),
            "w_k": pdef((n, d, cfg.d_ff), la + ("fsdp", "mlp")),
            "w_v": pdef((n, cfg.d_ff, d), la + ("mlp", "fsdp")),
            "w_r": pdef((n, d, d), la + (None, None)),
        },
    }
    return {
        "embed": pdef((cfg.vocab, d), ("vocab", "fsdp"), "embed"),
        "ln_in": pdef((d,), (None,), "ones"),
        "ln_in_b": pdef((d,), (None,), "zeros"),
        "ln_f": pdef((d,), (None,), "ones"),
        "ln_f_b": pdef((d,), (None,), "zeros"),
        "blocks": block,
    }


# ---------------------------------------------------------------------------
# WKV core

def wkv_sequential(r, k, v, w, u, s0=None):
    """Oracle: the recurrence step by step over T. r,k,v,w (B,T,H,hd); u
    (H,hd). Returns y (B,T,H,hd), final state (B,H,hd,hd) [f32]."""
    return wkv_ref.wkv_ref(r, k, v, w, u, s0)


def wkv_chunked(r, k, v, w, u, s0=None, chunk: int = 64):
    """The chunk-parallel form over the largest chunk <= `chunk` that
    halves down to a divisor of T (the reference's choice)."""
    T = r.shape[1]
    C = min(chunk, T)
    while T % C:
        C //= 2
    return wkv_ref.wkv_chunked_ref(r, k, v, w, u, s0, C)


def wkv_decode(r, k, v, w, u, s):
    """Single token. r,k,v,w (B,H,hd); s (B,H,hd,hd)."""
    rf, kf, vf, wf = (a.float() for a in (r, k, v, w))
    kv = kf[..., :, None] * vf[..., None, :]
    y = torch.einsum("bhi,bhij->bhj", rf,
                     u.float()[None, :, :, None] * kv + s)
    s_new = wf[..., :, None] * s + kv
    return y, s_new


# ---------------------------------------------------------------------------
# Blocks

def _token_shift(x, prev=None):
    """x (B,T,D) -> x_{t-1} (zeros at t=0 unless prev given)."""
    pad = torch.zeros_like(x[:, :1]) if prev is None \
        else prev[:, None].to(x.dtype)
    return torch.cat([pad, x[:, :-1]], dim=1)


def _time_mix(x, p, cfg: ModelConfig, mctx: MeshCtx = None, state=None,
              seq_mode="chunked"):
    cdt = x.dtype
    rw = cfg.rwkv
    hd = rw.head_dim
    B, T, D = x.shape
    w_r, w_k, w_v, w_g = (gather_fsdp(p[k], 0, mctx, D)
                          for k in ("w_r", "w_k", "w_v", "w_g"))
    C = w_r.shape[-1]                  # this rank's channels
    H = C // hd
    rnn = C < D                        # heads over "model"
    prev = state["shift"] if state is not None else None
    xp = _token_shift(x, prev)
    dx = xp - x
    xxx = x + dx * p["mu_base"].to(cdt)
    mixk = torch.tanh(xxx @ p["mix_w1"].to(cdt)).reshape(B, T, 5, rw.mix_lora)
    mixk = torch.einsum("btfr,frd->btfd", mixk, p["mix_w2"].to(cdt))
    xz = x[:, :, None, :] + dx[:, :, None, :] * (p["mu"].to(cdt) + mixk)
    xr, xw, xk, xv, xg = (xz[:, :, i] for i in range(5))
    hid = torch.tanh(xw.float() @ p["decay_w1"].float())
    per_channel = [p[k] for k in ("decay_w2", "decay_base", "ln_x_w",
                                  "ln_x_b")]
    bonus = p["bonus"]
    if rnn:
        # the whole inputs feed this rank's heads, and the replicated
        # per-channel params are cut to them: their gradients are the
        # ranks' parts
        xr, xk, xv, xg, hid = (copy_to_model(t, mctx)
                               for t in (xr, xk, xv, xg, hid))
        c0 = mctx.coordinate("model") * C
        per_channel = [copy_to_model(t, mctx).narrow(-1, c0, C)
                       for t in per_channel]
        bonus = copy_to_model(bonus, mctx).narrow(0, c0 // hd, H)
    decay_w2, decay_base, ln_x_w, ln_x_b = per_channel

    r = (xr @ w_r.to(cdt)).reshape(B, T, H, hd)
    kk = (xk @ w_k.to(cdt)).reshape(B, T, H, hd)
    vv = (xv @ w_v.to(cdt)).reshape(B, T, H, hd)
    g = F.silu(xg @ w_g.to(cdt))
    dlog = decay_base.float() + hid @ decay_w2.float()
    w = torch.exp(-torch.exp(dlog)).reshape(B, T, H, hd)          # (0,1)

    s0 = state["s"] if state is not None else None
    if T == 1 and state is not None:
        y, s_new = wkv_decode(r[:, 0], kk[:, 0], vv[:, 0], w[:, 0], bonus,
                              s0)
        y = y[:, None]
    elif seq_mode == "sequential":
        y, s_new = wkv_sequential(r, kk, vv, w, bonus, s0)
    elif cfg.attn_impl == "flash":
        # the chunked-WKV kernel (model-wide kernel-suite switch)
        from repro_torch.kernels.rwkv6_scan.ops import wkv6
        y, s_new = wkv6(r, kk, vv, w, bonus, s0)
    else:
        y, s_new = wkv_chunked(r, kk, vv, w, bonus, s0)
    y = y.reshape(B, T, C).to(cdt)
    # per-head group norm (population variance, as jnp.var)
    yh = y.reshape(B, T, H, hd)
    yf = yh.float()
    mu = torch.mean(yf, -1, keepdim=True)
    var = torch.var(yf, -1, keepdim=True, unbiased=False)
    yh = ((yh - mu) * torch.rsqrt(var + 64e-5)).to(cdt).reshape(B, T, C)
    y = yh * ln_x_w.to(cdt) + ln_x_b.to(cdt)
    out = (y * g) @ gather_fsdp(p["w_o"], 1, mctx, D).to(cdt)
    return ((reduce_from_model(out, mctx) if rnn else out),
            {"shift": L.last_positions(x, 1)[:, 0], "s": s_new})


def _channel_mix(x, p, cfg: ModelConfig, mctx: MeshCtx = None, state=None):
    cdt = x.dtype
    D = x.shape[-1]
    prev = state["shift"] if state is not None else None
    xp = _token_shift(x, prev)
    dx = xp - x
    xk = x + dx * p["mu_k"].to(cdt)
    xr = x + dx * p["mu_r"].to(cdt)
    w_k = gather_fsdp(p["w_k"], 0, mctx, D)
    w_v = gather_fsdp(p["w_v"], 1, mctx, D)
    cols = w_k.shape[-1] < cfg.d_ff    # hidden columns over "model"
    if cols:
        xk = copy_to_model(xk, mctx)
    k = torch.square(F.relu(xk @ w_k.to(cdt)))
    kv = k @ w_v.to(cdt)
    if cols:
        kv = reduce_from_model(kv, mctx)
    out = torch.sigmoid(xr @ p["w_r"].to(cdt)) * kv
    return out, {"shift": L.last_positions(x, 1)[:, 0]}


def _block(x, bp, cfg: ModelConfig, mctx: MeshCtx, state=None,
           seq_mode="chunked"):
    h = L.layer_norm(x, bp["ln1"], bp["ln1b"])
    tm, tstate = _time_mix(h, bp["tmix"], cfg, mctx,
                           state["tmix"] if state else None, seq_mode)
    x = x + tm
    h = L.layer_norm(x, bp["ln2"], bp["ln2b"])
    cm, cstate = _channel_mix(h, bp["cmix"], cfg, mctx,
                              state["cmix"] if state else None)
    x = x + cm
    if mctx is not None:
        x = mctx.constraint(x, mctx.batch_spec(None, None))
    return x, {"tmix": tstate, "cmix": cstate}


def _embed_in(params, tokens, cfg: ModelConfig, mctx: MeshCtx = None):
    return L.layer_norm(tr._embed_in(params, tokens, cfg, mctx),
                        params["ln_in"], params["ln_in_b"])


def forward(params, tokens, cfg: ModelConfig, mctx: MeshCtx,
            collect_state: bool = False, seq_mode: str = "chunked"):
    """tokens (B,T) -> logits (B,T,V) [+ the stacked state]; on a mesh
    with the vocab over "model", this rank's block of the logits. With
    cfg.remat, each layer keeps only its input for the backward while grad
    is enabled (the reference's jax.checkpoint over its scan body)."""
    x = _embed_in(params, tokens, cfg, mctx)
    remat = cfg.remat and torch.is_grad_enabled()
    states = []
    for i in range(cfg.n_layers):
        bp = _layer(params["blocks"], i)
        if remat:
            x, st = checkpoint(_block, x, bp, cfg, mctx, None, seq_mode,
                               use_reentrant=False, preserve_rng_state=False)
        else:
            x, st = _block(x, bp, cfg, mctx, None, seq_mode)
        states.append(st)
    x = L.layer_norm(x, params["ln_f"], params["ln_f_b"])
    logits = tr._unembed(params, x, cfg, mctx)
    if mctx is not None:
        logits = mctx.constraint(logits, mctx.batch_spec(None, "model"))
    if not collect_state:
        return logits
    return logits, tree_map(lambda *xs: torch.stack(xs), *states)


def loss_fn(params, batch, cfg: ModelConfig, mctx: MeshCtx):
    logits = forward(params, batch["tokens"], cfg, mctx)
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"),
                          mctx if logits.shape[-1] < cfg.vocab else None)


def state_spec(cfg: ModelConfig, batch: int,
               dtype: torch.dtype = torch.bfloat16):
    """Shapes and dtypes of the decode state: the token-shift rows in
    `dtype`, the WKV state float32."""
    n, d = cfg.n_layers, cfg.d_model
    hd = cfg.rwkv.head_dim
    h = d // hd
    return {
        "tmix": {"shift": CacheSpec((n, batch, d), dtype),
                 "s": CacheSpec((n, batch, h, hd, hd), torch.float32)},
        "cmix": {"shift": CacheSpec((n, batch, d), dtype)},
    }


def prefill(params, tokens, cfg: ModelConfig, mctx: MeshCtx):
    """Returns (last-token logits (B,V), stacked state)."""
    logits, state = forward(params, tokens, cfg, mctx, collect_state=True)
    return tr._whole_logits(logits[:, -1], cfg, mctx), state


def decode_step(params, token, pos, state, cfg: ModelConfig, mctx: MeshCtx):
    """token (B,) -> (logits (B,V), state), the state updated in place and
    returned. RWKV's state is position-free: `pos` is not read."""
    del pos
    x = _embed_in(params, token[:, None], cfg, mctx)
    for i in range(cfg.n_layers):
        st = _layer(state, i)
        x, new = _block(x, _layer(params["blocks"], i), cfg, mctx, st)
        tree_map(lambda d, s: d.copy_(s), st, new)
    x = L.layer_norm(x, params["ln_f"], params["ln_f_b"])
    return tr._whole_logits(tr._unembed(params, x, cfg, mctx)[:, 0], cfg,
                            mctx), state
