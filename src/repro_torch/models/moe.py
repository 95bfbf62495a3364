"""Mixture-of-Experts FFN, the counterpart of `repro/models/moe.py`
`moe_ffn`, on one device.

Token-choice routing with the reference's exact semantics: router logits
and softmax in float32, top-k with the lower expert index first on ties,
gates renormalised with a 1e-9 floor; each (token, k) assignment takes a
slot in its destination's buffer by a cumulative one-hot count in (token,
k) order, up to `cap` a destination; the second level groups the received
assignments by local expert, up to `cap2` an expert, and drops the rest.
Dropped assignments contribute zero and their gate weight is lost, as in
Switch/DBRX-style implementations.

On one device the expert-parallel group is one rank (ep = 1), so the two
all_to_alls are identities. The payload still travels in
`moe.dispatch_dtype` both ways: each value is rounded to it and back, with
the reference's float8_e4m3fn rule (`to_dispatch`). The reference drops an
assignment by writing it at an out-of-bounds slot (`mode="drop"`), which
on a CUDA tensor would be a device-side assert; the port writes it to a
spare row past the end of the buffer and cuts that row off (`_scatter`),
which needs no host sync.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.context import MeshCtx

# float8_e4m3fn's largest finite value is 448; the next step up would be
# 480, which is the format's NaN. Rounding to nearest even sends 464 (the
# midpoint) to 448 and anything above it to NaN, as XLA's convert does;
# torch's cast saturates there instead.
FP8_E4M3FN_NAN_ABOVE = 464.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def to_dispatch(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x cast to `dtype` as the reference's `x.astype(dtype)` casts it. For
    float8_e4m3fn a magnitude above 464, and ±inf, becomes NaN (keeping
    its sign) before torch's saturating cast, which then rounds the rest
    the same way."""
    if dtype != torch.float8_e4m3fn:
        return x.to(dtype)
    xf = x.float()
    nan = torch.copysign(torch.full_like(xf, math.nan), xf)
    return torch.where(xf.abs() > FP8_E4M3FN_NAN_ABOVE, nan, xf).to(dtype)


def _all_to_all(x: torch.Tensor) -> torch.Tensor:
    """The exchange over the expert-parallel group: the identity at ep = 1.
    The multi-device item of ROADMAP Queue 1 ("Multi-device") replaces it
    with torch.distributed's all_to_all_single."""
    return x


def _expert_mlp(buf: torch.Tensor, we: Dict[str, torch.Tensor],
                act: str) -> torch.Tensor:
    """buf (E_local, C, D) -> (E_local, C, D), one batched matmul per
    projection."""
    if act in ("swiglu", "geglu"):
        g = torch.matmul(buf, we["w_gate"])
        u = torch.matmul(buf, we["w_up"])
        h = (F.silu(g) if act == "swiglu"
             else F.gelu(g, approximate="tanh")) * u
        return torch.matmul(h, we["w_down"])
    h = torch.matmul(buf, we["w_in"])
    h = (torch.square(F.relu(h)) if act == "relu2"
         else F.gelu(h, approximate="tanh"))
    return torch.matmul(h, we["w_out"])


def _slots(dest: torch.Tensor, n: int) -> torch.Tensor:
    """Each row's slot in its destination: how many earlier rows went to
    the same one (cumsum of a one-hot, minus one, read at the row's own
    column). A destination of -1 matches no column and gets slot 0, as
    jax.nn.one_hot(-1) is an all-zero row."""
    oh = (dest[:, None] == torch.arange(n, device=dest.device)).to(
        torch.int32)
    return ((torch.cumsum(oh, dim=0, dtype=torch.int32) - 1) * oh).sum(1)


def _scatter(n: int, slot: torch.Tensor, ok: torch.Tensor,
             rows: torch.Tensor, fill: float = 0) -> torch.Tensor:
    """A buffer of n rows of `fill` with rows[i] at slot[i] where ok[i];
    the other rows are dropped into a spare row n, which is cut off."""
    out = rows.new_full((n + 1,) + rows.shape[1:], fill)
    return out.index_put((torch.where(ok, slot, n),), rows)[:n]


def moe_ffn(x: torch.Tensor, p: Dict[str, Any], cfg: ModelConfig,
            mctx: MeshCtx) -> torch.Tensor:
    """x (B, S, D) -> (B, S, D). p is one layer's MoE param slice."""
    mc = cfg.moe
    ep = mctx.tp_size() if mctx is not None else 1
    if ep != 1:
        raise NotImplementedError(
            "expert parallelism over more than one device waits for the "
            "multi-device item of ROADMAP Queue 1")
    e_per = mc.n_experts // ep
    cdt = x.dtype
    ddt = getattr(torch, mc.dispatch_dtype)
    K = mc.top_k
    B, S, D = x.shape
    T = B * S
    Tl = _round_up(max(T, ep), ep) // ep
    cap = _round_up(int(math.ceil(K * Tl * mc.capacity_factor / ep)), 8)
    cap2 = cap * ep if e_per == 1 else min(
        cap * ep, _round_up(int(math.ceil(cap * ep / e_per * 2.0)), 8))
    xs = x.reshape(T, D)

    # --- routing (float32) ---
    logits = xs.float() @ p["router"].float()                   # (Tl, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k takes the lower index first among equal values; a stable
    # descending sort does too, torch.topk does not
    gates, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :K], eidx[:, :K]
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)

    # --- first-level dispatch: destination EP rank ---
    dest = (eidx // e_per).reshape(-1)                          # (Tl*K,)
    le = (eidx % e_per).reshape(-1)
    pos = _slots(dest, ep)
    keep = pos < cap
    xa = xs[:, None, :].expand(Tl, K, D).reshape(-1, D)
    # the payload is rounded to the dispatch dtype and back: the values
    # the reference's send buffer holds after its cast back to cdt
    wire = to_dispatch(xa, ddt).to(cdt)
    slot = dest * cap + pos
    send_x = _scatter(ep * cap, slot, keep, wire).reshape(ep, cap, D)
    send_le = _scatter(ep * cap, slot, keep, le, fill=-1).reshape(ep, cap)
    rx = _all_to_all(send_x).reshape(ep * cap, D)
    rle = _all_to_all(send_le).reshape(ep * cap)

    # --- second-level dispatch: local expert grouping ---
    pos2 = _slots(rle, e_per)
    valid2 = (rle >= 0) & (pos2 < cap2)
    le_c = torch.where(valid2, rle, 0)
    buf = _scatter(e_per * cap2, le_c * cap2 + pos2, valid2,
                   rx).reshape(e_per, cap2, D)
    y_buf = _expert_mlp(buf, {k: v.to(cdt) for k, v in p["experts"].items()},
                        cfg.act)

    # --- reverse path (same wire format) ---
    pos2_c = torch.where(valid2, pos2, 0)
    y_tok = to_dispatch(y_buf[le_c, pos2_c] * valid2[:, None].to(cdt), ddt)
    back = _all_to_all(y_tok.to(cdt)).reshape(ep, cap, D)
    pos_c = torch.where(keep, pos, 0)
    ya = back[dest, pos_c] * keep[:, None].to(cdt)              # (Tl*K, D)
    out = torch.sum(ya.reshape(Tl, K, D) * gates[..., None].to(cdt), dim=1)

    if "shared" in p:
        out = out + L.mlp(xs, {k: v.to(cdt) for k, v in p["shared"].items()},
                          cfg.act)
    return out.reshape(B, S, D)
