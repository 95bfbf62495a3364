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
is not counted.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Tuple

import torch

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


def _forward(r, k, v, w, u, s0, chunk: int):
    if r.device.type == "cpu":
        return ref.wkv_plain(r, k, v, w, u, s0, chunk)
    y, s = K.wkv6(*(x.contiguous() for x in (r, k, v, w, u)),
                  None if s0 is None else s0.contiguous())
    if launching():
        with _launch_lock:
            LAUNCHES["fwd"] += 1
    return y, s


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk):
        ctx.has_s0 = s0 is not None
        ctx.save_for_backward(r, k, v, w, u, *([s0] if ctx.has_s0 else []))
        return _forward(r, k, v, w, u, s0, chunk)

    @staticmethod
    def backward(ctx, dy, ds):
        with torch.enable_grad():
            ins = [x.detach().requires_grad_() for x in ctx.saved_tensors]
            y, s = ref.wkv_ref(*ins)
            grads = torch.autograd.grad((y, s), ins, (dy, ds))
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
