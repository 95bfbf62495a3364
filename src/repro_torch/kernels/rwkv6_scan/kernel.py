"""The `wkv6` CUDA kernels (`csrc/wkv6.cu`): binding and launch.

The RWKV6 WKV recurrence in its chunk-parallel form (chunks of 32 steps,
any T) on PyTorch's current stream: y (B,T,H,hd) and the final state
(B,H,hd,hd), float32. One C call launches two kernels: `wkv6_kernel_state`
walks the chunks for tiles of the state and writes the state entering
every chunk to a workspace that this wrapper allocates, and
`wkv6_kernel_out` computes every chunk's output from it, their products
on the tensor cores in 3xTF32. They replace the TPU kernel
`repro/kernels/rwkv6_scan/kernel.py:88 wkv_chunked_tiles`; the source says
what bounds them and what the design does about that. The library is
built from the repo's sources on first use (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import call_on, refuse_fake

HEAD_DIMS = (16, 32, 64, 128)
CHUNK = 32                               # WKV_CHUNK of the source
SOURCE = "src/repro_torch/csrc/wkv6.cu"
REPLACES = "src/repro/kernels/rwkv6_scan/kernel.py:88"
KERNEL_NAME = "wkv6_kernel"              # in both __global__ names, as traced
KERNELS = ("wkv6_kernel_state", "wkv6_kernel_out")   # launched in this order
KERNELS_PER_CALL = len(KERNELS)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wkv6.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.wkv6.restype = ctypes.c_int
    lib.wkv6_smem.argtypes = [i, i]
    lib.wkv6_smem.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("wkv6", ["wkv6.cu"], _bind)


def build() -> None:
    """Build (or find) and load the library."""
    _lib()


def _check(x: torch.Tensor, shape: tuple, what: str, dev) -> None:
    if (x.device != dev or x.dtype != torch.float32
            or tuple(x.shape) != shape or not x.is_contiguous()):
        raise ValueError(f"wkv6 takes {what} as a contiguous float32 "
                         f"{shape} tensor on {dev}, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x itself, or a copy where its start is not 16-byte aligned (the
    kernels load rows with cp.async)."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def check(r, k, v, w, u, s0=None) -> None:
    """Raises on what the kernels do not take but a device other than the
    card, which the launch checks (its op's fake implementation checks a
    trace's tensors here)."""
    if r.dim() != 4:
        raise ValueError(f"wkv6 takes (B,T,H,hd) tensors, got "
                         f"{tuple(r.shape)}")
    B, T, H, hd = r.shape
    if hd not in HEAD_DIMS or B < 1 or T < 1 or H < 1:
        raise ValueError(f"wkv6 takes head_dim in {HEAD_DIMS} and B, T, H "
                         f">= 1, got {tuple(r.shape)}")
    for x, what in ((r, "r"), (k, "k"), (v, "v"), (w, "w")):
        _check(x, (B, T, H, hd), what, r.device)
    _check(u, (H, hd), "u", r.device)
    if s0 is not None:
        _check(s0, (B, H, hd, hd), "s0", r.device)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         w: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B,T,H,hd), u (H,hd), s0 (B,H,hd,hd) or None (zeros):
    contiguous float32 CUDA tensors, hd in HEAD_DIMS. Returns (y, final
    state). Raises on what the kernels do not take and if a launch
    fails."""
    refuse_fake("wkv6", r, k, v, w, u, s0)
    if r.device.type != "cuda" or r.dim() != 4:
        raise ValueError("wkv6 takes (B,T,H,hd) CUDA tensors, got "
                         f"{tuple(r.shape)} on {r.device}")
    check(r, k, v, w, u, s0)
    B, T, H, hd = r.shape
    if s0 is not None:
        s0 = _aligned(s0)
    r, k, v, w = (_aligned(x) for x in (r, k, v, w))
    y = torch.empty_like(r)
    s = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    ws = torch.empty((B, H, -(-T // CHUNK), hd, hd), dtype=torch.float32,
                     device=r.device)
    err = call_on(r.device.index, _lib().wkv6, r.data_ptr(), k.data_ptr(),
                  v.data_ptr(), w.data_ptr(), u.data_ptr(),
                  None if s0 is None else s0.data_ptr(), y.data_ptr(),
                  s.data_ptr(), ws.data_ptr(), B, T, H, hd)
    if err != 0:
        raise RuntimeError(f"wkv6 launch failed: CUDA error {err}")
    return y, s

