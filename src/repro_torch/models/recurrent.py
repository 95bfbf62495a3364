"""RecurrentGemma / Griffin-style hybrid: RG-LRU recurrent blocks and local
MQA, the counterpart of `repro/models/recurrent.py`.

Layer pattern: (R, R, A) super-blocks — `rnn_per_attn` recurrent blocks per
local-attention block — plus trailing recurrent blocks when n_layers is not
a multiple of the pattern (26 = 8x3 + 2 for recurrentgemma-2b).

State is O(1) in sequence length: RG-LRU hidden (B, R) and conv tail
(B, w-1, R) per recurrent layer; a rolling window cache for local
attention. The stacked params and states keep the reference's layout
(`super.rec` (n_super, k, ...), `super.attn` (n_super, ...), `tail`
(n_tail, ...)), walked by Python loops in place of `lax.scan`. With
attn_impl="flash" the recurrent blocks scan through the `rglru_scan`
kernel; the local attention keeps the plain chunked path in both modes,
as the reference passes it no `impl`. Decode updates the state in place
and returns it (the reference donates it).

On a mesh each rank computes on its params' local shards, as XLA
partitions the reference's specs. The recurrent mixer is column-parallel
over its `rnn` channels (`w_in`, `w_gate_in`, the depthwise conv, `lam`
and the gate columns of `w_a`, `w_x`), whose gates read the whole conv
output (gathered over "model"), scans its local channels and is
row-parallel out (`w_out`, summed over "model"); its state holds the
local channels. The local attention shards its q heads where they divide
the model ranks (each rank projects the kv heads whole and takes those
its heads use, as `transformer._gqa` does), else runs replicated; the MLP
is `layers.sharded_mlp`, the embedding and the tied logits vocab-parallel
(`transformer._embed_in`, `_unembed`). fsdp leaves are gathered over
"data" inside the layer.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref
from repro_torch.models import layers as L
from repro_torch.models.context import (MeshCtx, copy_to_model,
                                        gather_fsdp, gather_from_model,
                                        reduce_from_model)
from repro_torch.models.params import pdef, tree_map
from repro_torch.models.transformer import (CacheSpec, _embed_in, _kv_heads,
                                            _layer, _proj, _unembed,
                                            _whole_logits)

C_LRU = 8.0  # Griffin's fixed recurrence sharpness


# ---------------------------------------------------------------------------
# Param defs

def _rec_defs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    d = cfg.d_model
    r = cfg.hybrid.d_rnn or d
    w = cfg.hybrid.conv_width
    ax = (None,) * len(lead)
    return {
        "w_in": pdef(lead + (d, r), ax + ("fsdp", "rnn")),
        "w_gate_in": pdef(lead + (d, r), ax + ("fsdp", "rnn")),
        "conv_w": pdef(lead + (w, r), ax + (None, "rnn"), scale=0.3),
        "conv_b": pdef(lead + (r,), ax + ("rnn",), "zeros"),
        "w_a": pdef(lead + (r, r), ax + (None, "rnn")),
        "w_x": pdef(lead + (r, r), ax + (None, "rnn")),
        "lam": pdef(lead + (r,), ax + ("rnn",), "normal", scale=0.5),
        "w_out": pdef(lead + (r, d), ax + ("rnn", "fsdp")),
    }


def _attn_defs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    d = cfg.d_model
    ax = (None,) * len(lead)
    return {
        "w_q": pdef(lead + (d, cfg.n_heads, cfg.head_dim), ax + ("fsdp", "heads", None)),
        "w_k": pdef(lead + (d, cfg.n_kv_heads, cfg.head_dim), ax + ("fsdp", "kv_heads", None)),
        "w_v": pdef(lead + (d, cfg.n_kv_heads, cfg.head_dim), ax + ("fsdp", "kv_heads", None)),
        "w_o": pdef(lead + (cfg.n_heads, cfg.head_dim, d), ax + ("heads", None, "fsdp")),
    }


def _mlp_defs(cfg: ModelConfig, lead: Tuple[int, ...]) -> Dict[str, Any]:
    d, f = cfg.d_model, cfg.d_ff
    ax = (None,) * len(lead)
    return {
        "w_gate": pdef(lead + (d, f), ax + ("fsdp", "mlp")),
        "w_up": pdef(lead + (d, f), ax + ("fsdp", "mlp")),
        "w_down": pdef(lead + (f, d), ax + ("mlp", "fsdp")),
    }


def _wrap(defs_fn, cfg, lead):
    d = cfg.d_model
    ax = (None,) * len(lead)
    return {
        "ln_mix": pdef(lead + (d,), ax + (None,), "ones"),
        "ln_mlp": pdef(lead + (d,), ax + (None,), "ones"),
        "mix": defs_fn(cfg, lead),
        "mlp": _mlp_defs(cfg, lead),
    }


def pattern(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_super, n_trailing_recurrent)."""
    per = cfg.hybrid.rnn_per_attn + 1
    return cfg.n_layers // per, cfg.n_layers % per


def param_defs(cfg: ModelConfig) -> Dict[str, Any]:
    n_super, n_tail = pattern(cfg)
    k = cfg.hybrid.rnn_per_attn
    defs: Dict[str, Any] = {
        "embed": pdef((cfg.vocab, cfg.d_model), ("vocab", "fsdp"), "embed"),
        "ln_f": pdef((cfg.d_model,), (None,), "ones"),
        "super": {
            "rec": _wrap(_rec_defs, cfg, (n_super, k)),
            "attn": _wrap(_attn_defs, cfg, (n_super,)),
        },
    }
    if n_tail:
        defs["tail"] = _wrap(_rec_defs, cfg, (n_tail,))
    return defs


# ---------------------------------------------------------------------------
# RG-LRU

def _conv1d(u, conv_w, conv_b, tail=None):
    """Causal depthwise conv. u (B,T,R); conv_w (w,R). tail (B,w-1,R) or
    None. Returns (out, new tail)."""
    w = conv_w.shape[0]
    if tail is None:
        pad = torch.zeros((u.shape[0], w - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = tail.to(u.dtype)
    up = torch.cat([pad, u], dim=1)
    T = u.shape[1]
    out = up[:, 0:T] * conv_w[w - 1].to(u.dtype)
    for i in range(1, w):
        out = out + up[:, i:i + T] * conv_w[w - 1 - i].to(u.dtype)
    new_tail = L.last_positions(up, w - 1) if w > 1 else None
    return out + conv_b.to(u.dtype), new_tail


def _lru_gates(xt, p, mctx: MeshCtx = None):
    """a (decay) and gated input, float32. xt (B,T,R), the local channels
    on a mesh: the gate columns of `w_a` and `w_x` that a rank holds read
    every channel, so xt is gathered whole over "model" for them."""
    xf = xt.float()
    if p["w_a"].shape[-1] < p["w_a"].shape[0]:       # channels over "model"
        # each rank's gradient of the whole is the part its columns give
        xw = copy_to_model(gather_from_model(xf, -1, mctx), mctx)
    else:
        xw = xf
    rt = torch.sigmoid(xw @ p["w_a"].float())
    it = torch.sigmoid(xw @ p["w_x"].float())
    lam = p["lam"].float()
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-off
    log_a = -C_LRU * torch.logaddexp(lam, torch.zeros_like(lam)) * rt
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (it * xf)
    return a, gated


def _lru_scan(a, b, h0=None):
    """h_t = a_t*h_{t-1} + b_t over T (the plain path). a,b (B,T,R) f32."""
    return rglru_scan_ref(a, b, h0)


def _rec_mix(x, p, cfg: ModelConfig, mctx: MeshCtx = None, state=None):
    """Recurrent (RG-LRU) temporal mixing. Returns (out, new_state)."""
    cdt = x.dtype
    d = cfg.d_model
    w_in, w_gate_in = (gather_fsdp(p[k], 0, mctx, d)
                       for k in ("w_in", "w_gate_in"))
    rnn = w_in.shape[-1] < (cfg.hybrid.d_rnn or d)    # channels over "model"
    if rnn:
        x = copy_to_model(x, mctx)
    u = x @ w_in.to(cdt)
    gate = F.gelu(x @ w_gate_in.to(cdt), approximate="tanh")
    tail = state["conv"] if state is not None else None
    u, new_tail = _conv1d(u, p["conv_w"], p["conv_b"], tail)
    a, b = _lru_gates(u, p, mctx)
    h0 = state["h"] if state is not None else None
    if cfg.attn_impl == "flash":
        # "flash" selects the kernel suite model-wide; for the recurrent
        # mixer that is the rglru_scan kernel
        from repro_torch.kernels.rglru_scan.ops import rglru_scan
        h = rglru_scan(a, b, h0)
    else:
        h = _lru_scan(a, b, h0)
    out = (h.to(cdt) * gate) @ gather_fsdp(p["w_out"], 1, mctx, d).to(cdt)
    return ((reduce_from_model(out, mctx) if rnn else out),
            {"h": L.last_positions(h, 1)[:, 0], "conv": new_tail})


def _local_attn_mix(x, p, cfg: ModelConfig, positions, mctx: MeshCtx = None,
                    state=None, pos=None):
    """Local MQA with a rolling-window cache. Returns (out, new_state).

    Prefill (state None) runs the plain chunked attention within the
    window and returns the last W positions' k, v and positions, entry p
    at slot p % W. Decode writes this step's k, v and position at slot
    pos % W of the state in place and attends over the valid slots. On a
    mesh the q heads are this rank's where they divide the model ranks,
    and the state holds the kv heads its spec gives this rank."""
    cdt = x.dtype
    d = cfg.d_model
    W = cfg.hybrid.attn_window
    w_q, w_k, w_v = (gather_fsdp(p[k], 0, mctx, d)
                     for k in ("w_q", "w_k", "w_v"))
    hl, khl = w_q.shape[1], w_k.shape[1]
    heads = hl < cfg.n_heads           # q heads over "model"
    if heads:
        x = copy_to_model(x, mctx)
        if khl == cfg.n_kv_heads:      # kv heads whole: shared by ranks
            w_k, w_v = copy_to_model(w_k, mctx), copy_to_model(w_v, mctx)
    q = _proj(x, w_q)
    k = _proj(x, w_k)
    v = _proj(x, w_v)
    cos, sin = L.rope_freqs(positions, cfg.head_dim, cfg.rope_theta)
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    select = heads and khl == cfg.n_kv_heads
    if state is None:
        ka, va = _kv_heads(k, v, cfg, hl, mctx) if select else (k, v)
        out = L.attention(q, ka, va, q_positions=positions,
                          kv_positions=positions, causal=True, window=W)
        B, T = x.shape[0], x.shape[1]
        kpos = positions.to(torch.int32).expand(B, T)
        if T >= W:
            # decode writes at slot pos % W, so store entry p at slot p % W:
            # the last W positions are a cyclic rotation by T % W
            shift = T % W
            new_state = {
                "k": torch.roll(k[:, -W:], shift, dims=1),
                "v": torch.roll(v[:, -W:], shift, dims=1),
                "kpos": torch.roll(kpos[:, -W:], shift, dims=1),
            }
        else:
            # position i sits at slot i % W == i already; pad the rest
            padn = W - T
            new_state = {
                "k": F.pad(k, (0, 0, 0, 0, 0, padn)),
                "v": F.pad(v, (0, 0, 0, 0, 0, padn)),
                "kpos": F.pad(kpos, (0, padn), value=-10**9),
            }
    else:
        B = x.shape[0]
        slot = (pos % W).long()
        rows = torch.arange(B, device=x.device)
        ck, cv, cp = state["k"], state["v"], state["kpos"]
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        cp[rows, slot] = pos.to(torch.int32)
        ka, va = ck.to(cdt), cv.to(cdt)
        if select:
            ka, va = _kv_heads(ka, va, cfg, hl, mctx)
        # mask: within window and not in the future
        valid = (cp <= pos[:, None]) & (cp > (pos - W)[:, None])   # (B, W)
        KH, D = ka.shape[2], cfg.head_dim
        qg = q.reshape(B, 1, KH, hl // KH, D)
        # products of the compute dtype summed in float32, as the
        # reference's preferred_element_type=float32
        s = torch.einsum("btkgd,bskd->bkgts", qg.float(),
                         ka.float()) / math.sqrt(D)
        s = torch.where(valid[:, None, None, None, :], s,
                        torch.full((), -1e30, dtype=s.dtype, device=s.device))
        w_ = torch.softmax(s, dim=-1).to(cdt)
        out = torch.einsum("bkgts,bskd->btkgd", w_, va)
        out = out.reshape(B, 1, hl, D)
        new_state = {"k": ck, "v": cv, "kpos": cp}
    w_o = gather_fsdp(p["w_o"], 2, mctx, d)
    H, hd, _ = w_o.shape
    out = out.reshape(*out.shape[:2], H * hd) @ w_o.reshape(H * hd, d).to(cdt)
    return (reduce_from_model(out, mctx) if heads else out), new_state


def _block(x, bp, cfg: ModelConfig, mctx: MeshCtx, kind: str, positions,
           state=None, pos=None):
    h = L.rms_norm(x, bp["ln_mix"], cfg.rms_eps)
    if kind == "rec":
        mix, new_state = _rec_mix(h, bp["mix"], cfg, mctx, state)
    else:
        mix, new_state = _local_attn_mix(h, bp["mix"], cfg, positions, mctx,
                                         state, pos)
    x = x + mix
    h = L.rms_norm(x, bp["ln_mlp"], cfg.rms_eps)
    x = x + L.sharded_mlp(h, bp["mlp"], cfg.act, cfg.d_ff, mctx)
    if mctx is not None:
        x = mctx.constraint(x, mctx.batch_spec(None, None))
    return x, new_state


def _super_block(x, sp, cfg: ModelConfig, mctx: MeshCtx, positions):
    """One (R, ..., R, A) super-block of a prefill or training forward."""
    rec = []
    for j in range(cfg.hybrid.rnn_per_attn):
        x, st = _block(x, _layer(sp["rec"], j), cfg, mctx, "rec", positions)
        rec.append(st)
    x, attn = _block(x, sp["attn"], cfg, mctx, "attn", positions)
    return x, {"rec": tree_map(lambda *xs: torch.stack(xs), *rec),
               "attn": attn}


def _tail_block(x, rp, cfg: ModelConfig, mctx: MeshCtx, positions):
    return _block(x, rp, cfg, mctx, "rec", positions)


# ---------------------------------------------------------------------------
# Forward / loss / serve

def forward(params, tokens, cfg: ModelConfig, mctx: MeshCtx,
            collect_state: bool = False):
    """tokens (B,T) -> logits (B,T,V) [+ the stacked state]; on a mesh
    with the vocab over "model", this rank's block of the logits. With
    cfg.remat, each super-block and each trailing block keeps only its
    input for the backward while grad is enabled (the reference's
    jax.checkpoint over its scan bodies)."""
    x = _embed_in(params, tokens, cfg, mctx)
    positions = torch.arange(tokens.shape[1], device=x.device)
    n_super, n_tail = pattern(cfg)
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, x, p):
        if remat:
            return checkpoint(fn, x, p, cfg, mctx, positions,
                              use_reentrant=False, preserve_rng_state=False)
        return fn(x, p, cfg, mctx, positions)

    supers, tails = [], []
    for i in range(n_super):
        x, st = run(_super_block, x, _layer(params["super"], i))
        supers.append(st)
    for i in range(n_tail):
        x, st = run(_tail_block, x, _layer(params["tail"], i))
        tails.append(st)
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    logits = _unembed(params, x, cfg, mctx)
    if mctx is not None:
        logits = mctx.constraint(logits, mctx.batch_spec(None, "model"))
    if not collect_state:
        return logits

    def stack(states):
        return tree_map(lambda *xs: torch.stack(xs), *states)
    return logits, {"super": stack(supers),
                    "tail": stack(tails) if tails else None}


def loss_fn(params, batch, cfg: ModelConfig, mctx: MeshCtx):
    logits = forward(params, batch["tokens"], cfg, mctx)
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"),
                          mctx if logits.shape[-1] < cfg.vocab else None)


def state_spec(cfg: ModelConfig, batch: int,
               dtype: torch.dtype = torch.bfloat16):
    """Shapes and dtypes of the decode state (O(1) in seq_len): h float32,
    conv and the window's k, v in `dtype`, kpos int32."""
    n_super, n_tail = pattern(cfg)
    k = cfg.hybrid.rnn_per_attn
    r = cfg.hybrid.d_rnn or cfg.d_model
    W = cfg.hybrid.attn_window
    w = cfg.hybrid.conv_width

    def rec(lead):
        return {"h": CacheSpec(lead + (batch, r), torch.float32),
                "conv": CacheSpec(lead + (batch, w - 1, r), dtype)}

    kv = (n_super, batch, W, cfg.n_kv_heads, cfg.head_dim)
    return {"super": {"rec": rec((n_super, k)),
                      "attn": {"k": CacheSpec(kv, dtype),
                               "v": CacheSpec(kv, dtype),
                               "kpos": CacheSpec((n_super, batch, W),
                                                 torch.int32)}},
            "tail": rec((n_tail,)) if n_tail else None}


def prefill(params, tokens, cfg: ModelConfig, mctx: MeshCtx):
    """Returns (last-token logits (B,V), stacked state)."""
    logits, state = forward(params, tokens, cfg, mctx, collect_state=True)
    return _whole_logits(logits[:, -1], cfg, mctx), state


def _write_back(dst, src) -> None:
    """Copy a layer's new state into its views of the stacked state."""
    tree_map(lambda d, s: d if d is s else d.copy_(s), dst, src)


def decode_step(params, token, pos, state, cfg: ModelConfig, mctx: MeshCtx):
    """token (B,), pos (B,) -> (logits (B,V), state), the state updated in
    place and returned."""
    x = _embed_in(params, token[:, None], cfg, mctx)
    positions = pos[:, None]
    n_super, n_tail = pattern(cfg)
    for i in range(n_super):
        sp, st = _layer(params["super"], i), _layer(state["super"], i)
        for j in range(cfg.hybrid.rnn_per_attn):
            rst = _layer(st["rec"], j)
            x, new = _block(x, _layer(sp["rec"], j), cfg, mctx, "rec",
                            positions, state=rst, pos=pos)
            _write_back(rst, new)
        x, new = _block(x, sp["attn"], cfg, mctx, "attn", positions,
                        state=st["attn"], pos=pos)
        _write_back(st["attn"], new)
    for i in range(n_tail):
        rst = _layer(state["tail"], i)
        x, new = _block(x, _layer(params["tail"], i), cfg, mctx, "rec",
                        positions, state=rst, pos=pos)
        _write_back(rst, new)
    x = L.rms_norm(x, params["ln_f"], cfg.rms_eps)
    return _whole_logits(_unembed(params, x, cfg, mctx)[:, 0], cfg,
                         mctx), state
