"""Public wrapper for the RG-LRU scan kernel.

`rglru_scan(a, b, h0=None)` has the reference's semantics
(`repro/kernels/rglru_scan/ops.py:168-180`): h_t = a_t h_{t-1} + b_t over
axis 1, in float32, h0 zeros when None. A CUDA tensor goes to the
hand-written kernel `rglru_scan` (`csrc/rglru_scan.cu`), which takes any T
and R as they are, so nothing is padded on the card; a failed build or
launch raises, nothing falls back. A CPU tensor goes to the plain version
`ref.rglru_scan_ref`.

It is differentiable like the reference's custom_vjp: where grad is
enabled and an input requires it, it runs as `_RGLRUScan`, whose backward
is the adjoint recurrence

    g_t = dout_t + a_{t+1} g_{t+1},  da_t = g_t h_{t-1},  db_t = g_t,
    dh0 = a_0 g_0

computed by the same kernel in its reverse mode (a flag, not flips: the
kernel walks t from T-1 down, fed a shifted one step left), as the
reference runs its forward kernel on the time-reversed sequence
(`ops.py:149-162`). LAUNCHES["fwd"] and LAUNCHES["bwd"] count kernel
launches; a call captured into a CUDA graph launches nothing and is not
counted. The kernel is reached through the op `repro_torch::rglru_scan`
(`torch.library.custom_op`), which launches and counts; its fake
implementation runs the kernel's argument checks and makes the output's
shape and dtype, for a trace under FakeTensorMode, and `rglru_flops` is
its FLOP formula for `torch.utils.flop_counter` (and `chip_smoke.py`'s
bound).
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._launch import launching
from repro_torch.kernels.rglru_scan import kernel as K
from repro_torch.kernels.rglru_scan import ref

LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def rglru_flops(B: int, T: int, R: int) -> int:
    """The scan's FLOPs: one multiply-add an element."""
    return 2 * B * T * R


@torch.library.custom_op("repro_torch::rglru_scan", mutates_args=())
def _kernel(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor],
            reverse: bool) -> torch.Tensor:
    """The kernel's launch, counted under "bwd" when reversed (the
    backward's adjoint scan), else "fwd"."""
    h = K.rglru_scan(a, b, h0, reverse=reverse)
    if launching():
        with _launch_lock:
            LAUNCHES["bwd" if reverse else "fwd"] += 1
    return h


@_kernel.register_fake
def _(a, b, h0, reverse):
    K.check(a, b, h0)
    return torch.empty_like(a)


@register_flop_formula(torch.ops.repro_torch.rglru_scan)
def _(a, b, h0, reverse, *args, **kwargs) -> int:
    return rglru_flops(*a)


def _scan(a, b, h0, reverse: bool) -> torch.Tensor:
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b, h0, reverse=reverse)
    return torch.ops.repro_torch.rglru_scan(
        a.contiguous(), b.contiguous(),
        None if h0 is None else h0.contiguous(), reverse)


class _RGLRUScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, h0):
        h = _scan(a, b, h0, False)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dout):
        a, h, h0 = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
        g = _scan(a_next, dout.float(), None, True)
        first = torch.zeros_like(h[:, :1]) if h0 is None else h0[:, None]
        h_prev = torch.cat([first, h[:, :-1]], dim=1)
        dh0 = None if h0 is None else a[:, 0] * g[:, 0]
        return g * h_prev, g, dh0


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over axis 1. a, b (B,T,R); h0 (B,R) or
    None. Returns h (B,T,R) float32 on a's device."""
    a, b = a.float(), b.float()
    h0 = None if h0 is None else h0.float()
    if torch.is_grad_enabled() and any(
            x is not None and x.requires_grad for x in (a, b, h0)):
        return _RGLRUScan.apply(a, b, h0)
    return _scan(a, b, h0, False)
