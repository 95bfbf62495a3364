"""Mixture-of-Experts FFN, the counterpart of `repro/models/moe.py`
`moe_ffn`: token-choice routing with expert parallelism over the mesh's
"model" axis.

Token-choice routing with the reference's exact semantics: router logits
and softmax in float32, top-k with the lower expert index first on ties,
gates renormalised with a 1e-9 floor; each (token, k) assignment takes a
slot in its destination's buffer by a cumulative one-hot count in (token,
k) order, up to `cap` a destination; the second level groups the received
assignments by local expert, up to `cap2` an expert, and drops the rest.
Dropped assignments contribute zero and their gate weight is lost, as in
Switch/DBRX-style implementations. Capacities depend on the number of
ranks `ep` along "model", as in the reference.

With a mesh, `moe_ffn` is the body of the reference's shard_map, run by
every rank on its own block of the batch (x is this rank's local
block): model rank r
routes token slice r of the block, sends each assignment to the rank
holding its expert with `all_to_all_single` over the "model" group (the
payload and the local expert ids), runs its e_per experts, sends the
results back the same way and all-gathers the slices' outputs
(`context.gather_from_model`). The payload keeps `moe.dispatch_dtype` on
the wire both ways, moved as its bytes (an fp8 tensor viewed as uint8).
This holds whatever ep is: on a one-rank group the exchanges are real
collectives. Both exchanges are differentiable (the transpose of an
all-to-all is the reverse all-to-all); the gathered output's gradient is
the same on every model rank (the model around it is replicated along
"model"), so each keeps its slice of it, and the token slice's gradient
is all-gathered back (`context.scatter_to_model`).

The experts come as the layer's local shard (`experts` over "model", the
fsdp dim over "data", gathered for this layer only); whole experts, as a
caller without the train step's placement passes them, are sliced to
rank r's. The router is replicated, and its gradient, each rank's part
from its token slice, is summed over "model"; the shared experts run on
every token of the block as the dense MLP does (`layers.sharded_mlp`:
column- and row-parallel where their columns are over "model").

Without a mesh (ep = 1) the exchanges are identities, but the payload is
still rounded to the dispatch dtype and back, with the reference's
float8_e4m3fn rule (`to_dispatch`). The reference drops an assignment by
writing it at an out-of-bounds slot (`mode="drop"`), which on a CUDA
tensor would be a device-side assert; the port writes it to a spare row
past the end of the buffer and cuts that row off (`_scatter`), which
needs no host sync; a received local expert id outside [0, e_per) drops
its row too, as -1 does.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.context import (MeshCtx, copy_to_model, gather_fsdp,
                                        gather_from_model, scatter_to_model)

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


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    """x (n, ...), block j sent to rank j of `group`, the blocks received
    in rank order; moved as bytes, whatever the dtype."""
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out.view(torch.uint8), x.view(torch.uint8),
                           group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """`_exchange`, whose transpose is itself."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


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


def _local_experts(w: torch.Tensor, r: int, e_per: int, whole: int,
                   mctx: MeshCtx) -> torch.Tensor:
    """Rank r's e_per experts of one expert leaf (E or e_per, d_in,
    d_out), their fsdp dim (d_in, `whole`) gathered over "data"."""
    if w.shape[0] != e_per:
        w = w[r * e_per:(r + 1) * e_per]
    return gather_fsdp(w, 1, mctx, whole)


def moe_ffn(x: torch.Tensor, p: Dict[str, Any], cfg: ModelConfig,
            mctx: MeshCtx, reduce: bool = True):
    """x (B, S, D) -> (B, S, D). p is one layer's MoE param slice: on a
    mesh its local shard (rank r's experts) or whole; x is this rank's
    block of the batch, and model rank r runs experts [r * e_per, (r + 1)
    * e_per). With `reduce` False, what comes before the output's
    collectives, for `moe_sum`: this rank's token slice's outputs, and
    the shared experts' partial output (None without them)."""
    mc = cfg.moe
    mesh = None if mctx is None else mctx.device_mesh
    ep = 1 if mesh is None else mctx.tp_size()
    if mc.n_experts % ep:
        raise ValueError(f"{mc.n_experts} experts over {ep} model ranks")
    e_per = mc.n_experts // ep
    r = 0 if mesh is None else mctx.coordinate("model")
    group = None if mesh is None else mctx.group("model")
    cdt = x.dtype
    ddt = getattr(torch, mc.dispatch_dtype)
    K = mc.top_k
    B, S, D = x.shape
    T = B * S
    T_pad = _round_up(max(T, ep), ep)
    Tl = T_pad // ep
    cap = _round_up(int(math.ceil(K * Tl * mc.capacity_factor / ep)), 8)
    cap2 = cap * ep if e_per == 1 else min(
        cap * ep, _round_up(int(math.ceil(cap * ep / e_per * 2.0)), 8))
    xt = x.reshape(T, D)
    xp = xt if T_pad == T else F.pad(xt, (0, 0, 0, T_pad - T))
    xs = scatter_to_model(xp, 0, mctx)                         # (Tl, D)

    def wire(t: torch.Tensor) -> torch.Tensor:
        """t (ep, cap, ...) in the dispatch dtype, exchanged over the
        model group and back in cdt (without a mesh, only the cast)."""
        if mesh is not None:
            t = _AllToAll.apply(t, group)
        return t.to(cdt)

    # --- routing (float32) ---
    router = copy_to_model(p["router"], mctx)
    logits = xs.float() @ router.float()                        # (Tl, E)
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
    # the payload is rounded to the dispatch dtype: the values the
    # reference's send buffer holds
    payload = to_dispatch(xa, ddt).to(cdt)
    slot = dest * cap + pos
    send_x = _scatter(ep * cap, slot, keep, payload).reshape(ep, cap, D)
    send_le = _scatter(ep * cap, slot, keep, le, fill=-1).reshape(ep, cap)
    if mesh is None:
        rx = send_x.reshape(ep * cap, D)
        rle = send_le.reshape(ep * cap)
    else:
        rx = wire(send_x.to(ddt)).reshape(ep * cap, D)
        rle = _AllToAll.apply(send_le, group).reshape(ep * cap)

    # --- second-level dispatch: local expert grouping ---
    pos2 = _slots(rle, e_per)
    # an id past the local experts, which no real exchange delivers (a fake
    # group's leaves the buffer as the allocator held it), drops its row as
    # -1 does: indexed, it would be a device-side assert
    valid2 = (rle >= 0) & (rle < e_per) & (pos2 < cap2)
    le_c = torch.where(valid2, rle, 0)
    buf = _scatter(e_per * cap2, le_c * cap2 + pos2, valid2,
                   rx).reshape(e_per, cap2, D)
    d_in = {"w_gate": D, "w_up": D, "w_in": D, "w_down": mc.d_ff_expert,
            "w_out": mc.d_ff_expert}
    we = {k: _local_experts(v, r, e_per, d_in[k], mctx).to(cdt)
          for k, v in p["experts"].items()}
    y_buf = _expert_mlp(buf, we, cfg.act)

    # --- reverse path (same wire format) ---
    pos2_c = torch.where(valid2, pos2, 0)
    y_tok = to_dispatch(y_buf[le_c, pos2_c] * valid2[:, None].to(cdt), ddt)
    back = wire(y_tok.reshape(ep, cap, D))
    pos_c = torch.where(keep, pos, 0)
    ya = back[dest, pos_c] * keep[:, None].to(cdt)              # (Tl*K, D)
    out = torch.sum(ya.reshape(Tl, K, D) * gates[..., None].to(cdt), dim=1)

    if not reduce:
        return out, (L.sharded_mlp(xt, p["shared"], cfg.act,
                                   mc.n_shared * mc.d_ff_expert, mctx,
                                   reduce=False)
                     if "shared" in p else None)
    out = gather_from_model(out, 0, mctx)[:T]                   # (T, D)
    if "shared" in p:
        out = out + L.sharded_mlp(xt, p["shared"], cfg.act,
                                  mc.n_shared * mc.d_ff_expert, mctx)
    return out.reshape(B, S, D)


def moe_sum(part, p: Dict[str, Any], cfg: ModelConfig, mctx: MeshCtx,
            shape) -> torch.Tensor:
    """`moe_ffn`'s output of `shape` (B, S, D) from what it returns with
    `reduce` False: the token slices' outputs gathered over "model", plus
    the shared experts' output, summed there."""
    out, shared = part
    B, S, D = shape
    out = gather_from_model(out, 0, mctx)[:B * S]
    if shared is not None:
        mc = cfg.moe
        out = out + L.mlp_sum(shared, p["shared"],
                              mc.n_shared * mc.d_ff_expert, mctx)
    return out.reshape(B, S, D)
