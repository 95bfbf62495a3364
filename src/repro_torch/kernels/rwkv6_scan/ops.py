"""Public wrapper for the RWKV6 WKV kernel.

`wkv6(r, k, v, w, u, s0=None, chunk=32)` has the reference's semantics
(`repro/kernels/rwkv6_scan/ops.py:191-205`): float32 y (B,T,H,hd) and final
state (B,H,hd,hd), s0 zeros when None. A CPU tensor goes to the plain
version `ref.wkv_plain`, which picks the chunk and pads as the reference
does for its kernel (`ops.py:25-44`). A CUDA tensor goes to the
hand-written kernel `wkv6` (`csrc/wkv6.cu`), which takes any T in chunks
of its own 32 steps, so on the card nothing is padded and `chunk` has no
effect; a failed build or launch raises, nothing falls back.

It is differentiable like the reference's custom_vjp (`ops.py:167-188`):
the backward is autograd through the plain sequential version
`ref.wkv_ref`, on either device. LAUNCHES["fwd"] counts kernel calls
(two kernels each); a call captured into a CUDA graph launches nothing and
is not counted. The kernels are reached through the op
`repro_torch::wkv6` (`torch.library.custom_op`), which launches and
counts; its fake implementation runs the kernels' argument checks and
makes the outputs' shapes and dtypes, for a trace under FakeTensorMode,
and `wkv6_flops` is its FLOP formula for `torch.utils.flop_counter` (and
`chip_smoke.py`'s bound). The backward is one op too,
`repro_torch::wkv6_backward`, whose fake implementation makes the
gradients' shapes: a trace steps over the recurrence's T steps instead of
recording each (the transient state of those steps is then not in the
trace's memory record), and `wkv6_backward_flops` counts what the FLOP
counter counts of autograd through `ref.wkv_ref`.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._launch import launching
from repro_torch.kernels.rwkv6_scan import kernel as K
from repro_torch.kernels.rwkv6_scan import ref

DEFAULT_CHUNK = 32

LAUNCHES: Dict[str, int] = {"fwd": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def wkv6_flops(B: int, T: int, H: int, hd: int, chunk: int = K.CHUNK) -> int:
    """The chunked WKV's operations over the rows this T holds, exp and
    log counted as one and a multiply-add as two. Per chunk of n rows:
    8·n·hd to take logs, sum them and decay r and k; 2·n·hd² for
    (r·exp(cum_prev)) @ S; 5·hd a strictly causal (t, s) pair; 3·n·hd for
    the bonus; 2·hd a (t, s <= t) pair for att @ v; 2·n·hd² + hd² + hd for
    the state."""
    flops = 0
    for c0 in range(0, T, chunk):
        n = min(chunk, T - c0)
        flops += (8 * n * hd + 2 * n * hd * hd + 5 * hd * n * (n - 1) // 2
                  + 3 * n * hd + 2 * hd * n * (n + 1) // 2
                  + 2 * n * hd * hd + hd * hd + hd)
    return flops * B * H


@torch.library.custom_op("repro_torch::wkv6", mutates_args=())
def _kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' launch, counted."""
    y, s = K.wkv6(r, k, v, w, u, s0)
    if launching():
        with _launch_lock:
            LAUNCHES["fwd"] += 1
    return y, s


@_kernel.register_fake
def _(r, k, v, w, u, s0):
    K.check(r, k, v, w, u, s0)
    B, T, H, hd = r.shape
    return torch.empty_like(r), r.new_empty((B, H, hd, hd))


@register_flop_formula(torch.ops.repro_torch.wkv6)
def _(r, k, v, w, u, s0, *args, **kwargs) -> int:
    return wkv6_flops(*r)


def _forward(r, k, v, w, u, s0, chunk: int):
    if r.device.type == "cpu":
        return ref.wkv_plain(r, k, v, w, u, s0, chunk)
    return torch.ops.repro_torch.wkv6(
        *(x.contiguous() for x in (r, k, v, w, u)),
        None if s0 is None else s0.contiguous())


def wkv6_backward_flops(B: int, T: int, H: int, hd: int) -> int:
    """The products of autograd through the sequential recurrence: each
    step's r_t @ (u k_t v_t + S) again (2·hd² a head) and its two
    transposes."""
    return 6 * B * T * H * hd * hd


@torch.library.custom_op("repro_torch::wkv6_backward", mutates_args=())
def _backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
              dy: torch.Tensor, ds: torch.Tensor) -> List[torch.Tensor]:
    """The gradients of r, k, v, w, u (and s0, where given): autograd
    through the sequential recurrence `ref.wkv_ref`, as the reference's
    custom_vjp is `jax.vjp` of its oracle."""
    # an op's implementation runs below autograd, its keys excluded: they
    # are let through again for the recurrence (torch.func's vjp, which
    # needs no keys, fails when the op is called under a Python dispatch
    # mode, such as the step recorder of `roofline/collectives.py`)
    ins = [x.detach().requires_grad_() for x in (r, k, v, w, u, s0)
           if x is not None]
    keys = torch._C.DispatchKey
    with torch._C._SetExcludeDispatchKeyGuard(keys.AutogradFunctionality,
                                              False), \
            torch._C._SetExcludeDispatchKeyGuard(keys.ADInplaceOrView,
                                                 False), \
            torch.enable_grad():
        return list(torch.autograd.grad(ref.wkv_ref(*ins), ins, (dy, ds)))


@_backward.register_fake
def _(r, k, v, w, u, s0, dy, ds):
    return [torch.empty_like(x) for x in (r, k, v, w, u, s0)
            if x is not None]


@register_flop_formula(torch.ops.repro_torch.wkv6_backward)
def _(r, *args, **kwargs) -> int:
    return wkv6_backward_flops(*r)


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        ctx.has_s0 = s0 is not None
        ctx.save_for_backward(r, k, v, w, u, *([s0] if ctx.has_s0 else []))
        return _forward(r, k, v, w, u, s0, chunk)

    @staticmethod
    def backward(ctx, dy, ds):
        saved = ctx.saved_tensors
        grads = torch.ops.repro_torch.wkv6_backward(
            *saved[:5], saved[5] if ctx.has_s0 else None,
            dy.contiguous(), ds.contiguous())
        return (*grads, *(() if ctx.has_s0 else (None,)), None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, s0: Optional[torch.Tensor] = None,
         chunk: int = DEFAULT_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 time-mix. r,k,v,w (B,T,H,hd); u (H,hd); s0 (B,H,hd,hd) or
    None (zeros). Returns (y (B,T,H,hd), final state (B,H,hd,hd)),
    float32."""
    ins = [x.float() for x in (r, k, v, w, u)]
    s0 = None if s0 is None else s0.float()
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (*ins, s0)):
        return _WKV6.apply(*ins, s0, int(chunk))
    return _forward(*ins, s0, int(chunk))
