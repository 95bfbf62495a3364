"""The `fletcher` CUDA kernel (`csrc/fletcher.cu`): binding and launch.

[s1, s2] of the little-endian u32 words of a byte stream (the last word
zero-padded), on PyTorch's current stream. It replaces the TPU kernel
`repro/kernels/fletcher/kernel.py:56 fletcher_tiles`; the source says what
bounds it and what its design does about that. The library is built from
the repo's sources on first use (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

SOURCE = "src/repro_torch/csrc/fletcher.cu"
REPLACES = "src/repro/kernels/fletcher/kernel.py:56"
KERNEL_NAME = "fletcher_kernel"         # the __global__ function, as traced


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.fletcher.argtypes = [p, ctypes.c_int64, p, p]
    lib.fletcher.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("fletcher", ["fletcher.cu"], _bind)


def build() -> None:
    """Build (or find) and load the library."""
    _lib()


def fletcher(x: torch.Tensor) -> torch.Tensor:
    """x: a contiguous, non-empty uint8 or uint32 CUDA tensor, read as its
    bytes. Returns (2,) uint32 [s1, s2] on x's device. Any start address
    works. Raises on what the kernel does not take and if the launch
    fails."""
    if (x.device.type != "cuda" or x.dtype not in (torch.uint8, torch.uint32)
            or not x.is_contiguous() or x.numel() == 0):
        raise ValueError("fletcher takes a contiguous, non-empty uint8 or "
                         f"uint32 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")
    out = torch.empty(2, dtype=torch.uint32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fletcher(x.data_ptr(), x.numel() * x.element_size(),
                           out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"fletcher launch failed: CUDA error {err}")
    return out
