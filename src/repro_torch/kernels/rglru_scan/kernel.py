"""The `rglru_scan` CUDA kernel (`csrc/rglru_scan.cu`): binding and launch.

h_t = a_t h_{t-1} + b_t over (B, T, R) float32 on PyTorch's current
stream, forward or (with `reverse`) from the last step down. It replaces
the TPU kernel `repro/kernels/rglru_scan/kernel.py:51 rglru_scan_tiles`;
the source says what bounds it and what its design does about that: for
T > SEG, T is split across the warps of a CTA in windows of SEG steps a
warp, their carries folded in shared memory (`rglru_scan_chunk_kernel`);
T <= SEG, as in decode, takes a thread a channel
(`rglru_scan_short_kernel`). One launch a call. The library is built from
the repo's sources on first use (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import call_on, refuse_fake

SOURCE = "src/repro_torch/csrc/rglru_scan.cu"
REPLACES = "src/repro/kernels/rglru_scan/kernel.py:51"
KERNEL_NAME = "rglru_scan_"   # both __global__ names, as traced; one a call
SEG = 8                       # RGLRU_SEG: steps a warp takes of each window
WARPS = 8                     # RGLRU_WARPS: most warps of a CTA along T
WINDOW = SEG * WARPS          # steps a CTA of WARPS warps takes at a time


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rglru_scan.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.rglru_scan.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("rglru_scan", ["rglru_scan.cu"], _bind)


def build() -> None:
    """Build (or find) and load the library."""
    _lib()


def _check(x: torch.Tensor, shape: tuple, what: str, dev) -> None:
    if (x.device != dev or x.dtype != torch.float32
            or tuple(x.shape) != shape or not x.is_contiguous()):
        raise ValueError(f"rglru_scan takes {what} as a contiguous float32 "
                         f"{shape} tensor on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def check(a: torch.Tensor, b: torch.Tensor,
          h0: Optional[torch.Tensor] = None) -> None:
    """Raises on what the kernel does not take but a device other than the
    card, which the launch checks (its op's fake implementation checks a
    trace's tensors here)."""
    if a.dim() != 3:
        raise ValueError(f"rglru_scan takes (B,T,R) tensors, got "
                         f"{tuple(a.shape)}")
    B, T, R = a.shape
    _check(a, (B, T, R), "a", a.device)
    _check(b, (B, T, R), "b", a.device)
    if h0 is not None:
        _check(h0, (B, R), "h0", a.device)


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: Optional[torch.Tensor] = None, *,
               reverse: bool = False) -> torch.Tensor:
    """a, b (B,T,R) and h0 (B,R) or None: contiguous float32 CUDA tensors.
    Returns h (B,T,R) float32. Raises on what the kernel does not take and
    if the launch fails."""
    refuse_fake("rglru_scan", a, b, h0)
    if a.device.type != "cuda" or a.dim() != 3:
        raise ValueError("rglru_scan takes (B,T,R) CUDA tensors, got "
                         f"{tuple(a.shape)} on {a.device}")
    check(a, b, h0)
    B, T, R = a.shape
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    err = call_on(a.device.index, _lib().rglru_scan, a.data_ptr(),
                  b.data_ptr(), None if h0 is None else h0.data_ptr(),
                  h.data_ptr(), B, T, R, int(bool(reverse)))
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    return h
