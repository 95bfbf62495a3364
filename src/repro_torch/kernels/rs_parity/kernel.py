"""The `rs_matmul` CUDA kernel (`csrc/rs_parity.cu`): binding and launch.

GF(2^8) product out[m, L] = mat[m, s] x cells[s, L] over u8 rows, on
PyTorch's current stream. It replaces the TPU kernel
`repro/kernels/rs_parity/kernel.py:53 rs_matmul_tiles`; the source says
what bounds it and what its design does about that. The kernel takes each
coefficient as two 16-entry product tables, which `nibble_tables`
computes here on the host. The library is built from the repo's sources
on first use (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import call_on
from repro_torch.kernels.rs_parity import ref

MAX_ROWS = 11                   # m, s <= 11: any ec(k,p) up to ec(8,3)
SOURCE = "src/repro_torch/csrc/rs_parity.cu"
REPLACES = "src/repro/kernels/rs_parity/kernel.py:53"
KERNEL_NAME = "rs_matmul_prmt_kernel"   # the __global__ function, traced

# GF_MUL[c, v] = c * v over GF(2^8)
GF_MUL = np.array([ref.gf_mul_vec(c, np.arange(256, dtype=np.uint8))
                   for c in range(256)], np.uint8)


@functools.lru_cache(maxsize=256)
def _tables(coef: bytes, m: int, s: int) -> bytes:
    mat = np.frombuffer(coef, np.uint8).reshape(m, s)
    nib = np.arange(16, dtype=np.uint8)
    lo = GF_MUL[mat[:, :, None], nib]                    # c * v,      v < 16
    hi = GF_MUL[mat[:, :, None], nib << 4]               # c * (v << 4)
    return np.ascontiguousarray(np.concatenate([lo, hi], axis=2)).tobytes()


def nibble_tables(mat: np.ndarray) -> np.ndarray:
    """The kernel's form of an (m, s) u8 coefficient matrix: (m, s, 8)
    u32, for each coefficient c its tables lo[v] = c*v and hi[v] =
    c*(v << 4) over GF(2^8), v < 16, four entries a word, little-endian
    (entry e in byte e % 4 of word e // 4; hi from word 4). GF
    multiplication by c is linear over GF(2), so c*x = lo[x & 15] ^
    hi[x >> 4]. Cached on the matrix's bytes: the EC path reuses a few
    matrices for every stripe."""
    coef = np.ascontiguousarray(mat, np.uint8)
    m, s = coef.shape
    return np.frombuffer(_tables(coef.tobytes(), m, s),
                         "<u4").reshape(m, s, 8)


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
    aligned and L need not be a multiple of 4. Raises if the launch is
    refused."""
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
    err = call_on(cells.device.index, _lib().rs_matmul,
                  _tables(coef.tobytes(), m, s), m, s, cells.data_ptr(),
                  out.data_ptr(), n)
    if err != 0:
        raise RuntimeError(f"rs_matmul launch failed: CUDA error {err}")
    return out
