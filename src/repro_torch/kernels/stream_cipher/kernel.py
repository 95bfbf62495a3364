"""The `stream_cipher` CUDA kernel (`csrc/stream_cipher.cu`): binding and
launch.

XORs the bytes of a u8 or u32 stream with the murmur3 keystream of
(key, nonce), word j of the stream taking ks(j), on PyTorch's current
stream. It replaces the TPU kernel
`repro/kernels/stream_cipher/kernel.py:54 cipher_tiles`; the source says
what bounds it and what its design does about that. The library is built
from the repo's sources on first use (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _launch
from repro_torch.kernels.stream_cipher.ref import MASK32

SOURCE = "src/repro_torch/csrc/stream_cipher.cu"
REPLACES = "src/repro/kernels/stream_cipher/kernel.py:54"
KERNEL_NAME = "stream_cipher_kernel"    # the __global__ function, as traced


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.stream_cipher.argtypes = [p, p, ctypes.c_int64, ctypes.c_uint32,
                                  ctypes.c_uint32, p]
    lib.stream_cipher.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("stream_cipher", ["stream_cipher.cu"], _bind)


def build() -> None:
    """Build (or find) and load the library."""
    _lib()


def cipher(x: torch.Tensor, key: int, nonce: int) -> torch.Tensor:
    """x: a contiguous, non-empty uint8 or uint32 CUDA tensor. Returns the
    ciphered stream, a new tensor of x's shape and dtype; a u8 stream's
    last word reads as zero-padded. Key and nonce are taken mod 2^32. Any
    start address works (a byte view need not be 16-byte aligned). Raises
    on what the kernel does not take and if the launch fails."""
    _launch.check_bytes(x, "stream_cipher")
    out = torch.empty_like(x)
    err = _launch.call_on(x.device.index, _lib().stream_cipher, x.data_ptr(),
                          out.data_ptr(), x.numel() * x.element_size(),
                          int(key) & MASK32, int(nonce) & MASK32)
    if err != 0:
        raise RuntimeError(f"stream_cipher launch failed: CUDA error {err}")
    return out
