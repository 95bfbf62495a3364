"""The `rs_matmul` CUDA kernel (`csrc/rs_parity.cu`): binding and launch.

GF(2^8) product out[m, L] = mat[m, s] x cells[s, L] over u8 rows, on
PyTorch's current stream. It replaces the TPU kernel
`repro/kernels/rs_parity/kernel.py:53 rs_matmul_tiles`; the source says
what bounds it and what its design does about that. The library is built
from the repo's sources on first use (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import _build

MAX_ROWS = 11                   # m, s <= 11: any ec(k,p) up to ec(8,3)
SOURCE = "src/repro_torch/csrc/rs_parity.cu"
REPLACES = "src/repro/kernels/rs_parity/kernel.py:53"


def _bind(lib: ctypes.CDLL) -> None:
    lib.rs_matmul.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_void_p]
    lib.rs_matmul.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("rs_parity", ["rs_parity.cu"], _bind)


def build() -> None:
    """Build (or find) and load the library."""
    _lib()


def rs_matmul(mat: np.ndarray, cells: torch.Tensor) -> torch.Tensor:
    """(m, s) u8 host coefficients times (s, L) u8 CUDA rows -> (m, L) u8
    on the same device. `cells` must be contiguous; its start need not be
    16-byte aligned and L need not be a multiple of 16. Raises if the
    launch is refused."""
    coef = np.ascontiguousarray(mat, np.uint8)
    m, s = coef.shape
    if not (1 <= m <= MAX_ROWS and 1 <= s <= MAX_ROWS):
        raise ValueError(f"rs_matmul takes m, s in 1..{MAX_ROWS}, "
                         f"got {coef.shape}")
    if cells.device.type != "cuda" or cells.dtype != torch.uint8:
        raise ValueError("rs_matmul takes a uint8 CUDA tensor, got "
                         f"{cells.dtype} on {cells.device}")
    if cells.dim() != 2 or cells.shape[0] != s or not cells.is_contiguous():
        raise ValueError(f"rs_matmul takes contiguous ({s}, L) rows, got "
                         f"{tuple(cells.shape)}")
    n = cells.shape[1]
    out = torch.empty((m, n), dtype=torch.uint8, device=cells.device)
    lib = _lib()
    with torch.cuda.device(cells.device):
        stream = torch.cuda.current_stream(cells.device).cuda_stream
        err = lib.rs_matmul(coef.tobytes(), m, s, cells.data_ptr(),
                            out.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"rs_matmul launch failed: CUDA error {err}")
    return out
