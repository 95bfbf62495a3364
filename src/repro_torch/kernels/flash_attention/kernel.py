"""The `flash_attention_fwd` CUDA kernel (`csrc/flash_attention_fwd.cu`):
binding and launch.

Online-softmax GQA attention forward on PyTorch's current stream: out
(B,T,H,D) in q's dtype and lse (B,H,T) in float32. It replaces the TPU
kernel `repro/kernels/flash_attention/kernel.py:101 flash_attention_fwd`;
the source says what bounds it and what its design does about that. The
library is built from the repo's sources on first use (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels import _build
from repro_torch.kernels._launch import call_on, refuse_fake

HEAD_DIMS = (64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SOURCE = "src/repro_torch/csrc/flash_attention_fwd.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel.py:101"
KERNEL_NAME = "flash_fwd_kernel"        # the __global__ function, as traced


def _bind(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.flash_attention_fwd.argtypes = [
        i, i, i, i, i, i, i, p, p, p, p, p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_float, i, i, ctypes.c_float, i, p]
    lib.flash_attention_fwd.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention_fwd", ["flash_attention_fwd.cu"],
                       _bind)


def build() -> None:
    """Build (or find) and load the library."""
    _lib()


def readable(x: torch.Tensor, what: str,
             kernel: str = "flash_attention_fwd") -> None:
    """The flash kernels read rows of 16 bytes in place: the last dimension
    must be contiguous and every row start 16-byte aligned (of a fake
    tensor the strides are checked; it has no address)."""
    per16 = 16 // x.element_size()
    if (x.stride(-1) != 1
            or (not isinstance(x, FakeTensor) and x.data_ptr() % 16)
            or any(s % per16 for s in x.stride()[:-1])):
        raise ValueError(f"{kernel} reads {what} in place: its "
                         "last dimension must be contiguous and its rows "
                         f"16-byte aligned, got strides {x.stride()}")


def check_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: Optional[int] = None, softcap: Optional[float] = None,
              seq_k: Optional[int] = None) -> int:
    """Raises on what the kernel does not take but the device, which the
    launch checks (its op's fake implementation checks a trace's tensors
    here); returns seq_k (default S)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention_fwd takes float32 or bfloat16 q, "
                         f"k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D not in HEAD_DIMS or k.shape != (B, S, KH, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention_fwd takes head_dim in {HEAD_DIMS} "
                         f"and k, v of shape (B,S,KH,D); got q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be positive, got {softcap}")
    seq_k = S if seq_k is None else int(seq_k)
    if not 0 <= seq_k <= S:
        raise ValueError(f"seq_k {seq_k} outside 0..{S}")
    for x, what in ((q, "q"), (k, "k"), (v, "v")):
        readable(x, what)
    return seq_k


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        seq_k: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,T,H,D), k and v (B,S,KH,D) CUDA tensors of one dtype (float32
    or bfloat16), D in HEAD_DIMS, H % KH == 0. Keys at positions >= seq_k
    (default S) are masked. Returns (out (B,T,H,D), lse (B,H,T) float32).
    Raises on what the kernel does not take and if the launch fails."""
    refuse_fake("flash_attention_fwd", q, k, v)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention_fwd takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    seq_k = check_fwd(q, k, v, window, softcap, seq_k)
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_int64 * 12)(*q.stride()[:3], *k.stride()[:3],
                                    *v.stride()[:3], *out.stride()[:3])
    err = call_on(
        q.device.index, _lib().flash_attention_fwd, DTYPES[q.dtype], B, T, S,
        H, KH, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), strides, float(scale), int(bool(causal)),
        int(window or 0), float(softcap or 0.0), seq_k)
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd launch failed: CUDA error "
                           f"{err}")
    return out, lse
