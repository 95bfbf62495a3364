"""The `flash_attention_bwd` CUDA kernels (`csrc/flash_attention_bwd.cu`):
binding and launch.

The backward of GQA flash attention recomputed from the forward's lse, on
PyTorch's current stream: a dq kernel and a dk/dv kernel, launched one
after the other by one call. dk and dv come out already summed over each
GQA group, (B,S,KH,D). It replaces the TPU kernel
`repro/kernels/flash_attention/kernel_bwd.py:130 flash_attention_bwd`;
the source says what bounds it and what its design does about that. The
library is built from the repo's sources on first use (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import call_on, refuse_fake
from repro_torch.kernels.flash_attention.kernel import (DTYPES, HEAD_DIMS,
                                                        readable)

SOURCE = "src/repro_torch/csrc/flash_attention_bwd.cu"
REPLACES = "src/repro/kernels/flash_attention/kernel_bwd.py:130"
KERNEL_NAME = "flash_bwd_"     # prefix of both __global__ functions, as traced
KERNELS_PER_CALL = 2           # flash_bwd_dq_kernel, flash_bwd_dkv_kernel


def _bind(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.flash_attention_bwd.argtypes = [
        i, i, i, i, i, i, i, p, p, p, p, p, p, p, p, p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_float, i, i, i, p]
    lib.flash_attention_bwd.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("flash_attention_bwd", ["flash_attention_bwd.cu"],
                       _bind)


def build() -> None:
    """Build (or find) and load the library."""
    _lib()


def check_bwd(q, k, v, dout, lse, delta, window: Optional[int] = None,
              seq_k: Optional[int] = None) -> int:
    """Raises on what the kernels do not take but the device, which the
    launch checks (its op's fake implementation checks a trace's tensors
    here); returns seq_k (default S)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    name = "flash_attention_bwd"
    if q.dtype not in DTYPES or any(x.dtype != q.dtype for x in (k, v, dout)):
        raise ValueError(f"{name} takes float32 or bfloat16 q, k, v, dout of "
                         f"one dtype, got {q.dtype}, {k.dtype}, {v.dtype}, "
                         f"{dout.dtype}")
    if (D not in HEAD_DIMS or k.shape != (B, S, KH, D) or v.shape != k.shape
            or dout.shape != q.shape):
        raise ValueError(f"{name} takes head_dim in {HEAD_DIMS}, dout shaped "
                         f"like q and k, v of shape (B,S,KH,D); got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, dout {tuple(dout.shape)}")
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    for x, what in ((lse, "lse"), (delta, "delta")):
        if (x.dtype != torch.float32 or x.shape != (B, H, T)
                or not x.is_contiguous()):
            raise ValueError(f"{name} takes {what} as a contiguous float32 "
                             f"(B,H,T) tensor, got {x.dtype} "
                             f"{tuple(x.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    seq_k = S if seq_k is None else int(seq_k)
    if not 0 <= seq_k <= S:
        raise ValueError(f"seq_k {seq_k} outside 0..{S}")
    for x, what in ((q, "q"), (k, "k"), (v, "v"), (dout, "dout")):
        readable(x, what, name)
    return seq_k


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        delta: torch.Tensor, *, scale: float,
                        causal: bool = True, window: Optional[int] = None,
                        seq_k: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q and dout (B,T,H,D), k and v (B,S,KH,D) CUDA tensors of one dtype
    (float32 or bfloat16), D in HEAD_DIMS, H % KH == 0; lse and delta =
    rowsum(dout * out) (B,H,T) contiguous float32. Keys at positions >=
    seq_k (default S) are masked. Returns (dq (B,T,H,D), dk, dv (B,S,KH,D))
    in q's dtype. Raises on what the kernels do not take and if a launch
    fails."""
    refuse_fake("flash_attention_bwd", q, k, v, dout, lse, delta)
    if any(x.device.type != "cuda" or x.device != q.device
           for x in (q, k, v, dout, lse, delta)):
        raise ValueError("flash_attention_bwd takes CUDA tensors on one "
                         "device")
    seq_k = check_bwd(q, k, v, dout, lse, delta, window, seq_k)
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    strides = (ctypes.c_int64 * 21)(*(s for x in (q, k, v, dout, dq, dk, dv)
                                      for s in x.stride()[:3]))
    err = call_on(
        q.device.index, _lib().flash_attention_bwd, DTYPES[q.dtype], B, T, S,
        H, KH, D, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), strides, float(scale), int(bool(causal)),
        int(window or 0), seq_k)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error "
                           f"{err}")
    return dq, dk, dv
