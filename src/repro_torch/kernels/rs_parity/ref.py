"""Pure-numpy oracle for the GF(256) Reed-Solomon parity kernel.

The ec(k,p) redundancy class stripes k data cells + p parity cells per
block. Parity is a systematic Reed-Solomon code over GF(2^8) with the
AES/QR polynomial x^8+x^4+x^3+x^2+1 (0x11D): the generator matrix is
[I_k ; C] where C is the p x k Cauchy matrix C[j][i] = 1/(x_j + y_i)
with x_j = k + j, y_i = i. Every square submatrix of a Cauchy matrix is
nonsingular, so ANY k of the k+p cells reconstruct the stripe (the MDS
property degraded reads and rebuild depend on).

Everything here is table-driven numpy — the oracle the CUDA kernel
(kernel.py, `csrc/rs_parity.cu`) and its plain PyTorch version
(`gf_matmul_torch`, the shift/xor form) are tested against.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

GF_POLY = 0x11D                 # x^8 + x^4 + x^3 + x^2 + 1


def _build_tables() -> Tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, np.int32)
    log = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[:255]    # wraparound so log[a]+log[b] never reduces
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(GF_EXP[GF_LOG[a] + GF_LOG[b]])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(GF_EXP[255 - GF_LOG[a]])


def gf_mul_vec(c: int, v: np.ndarray) -> np.ndarray:
    """Constant times u8 vector over GF(256), table form."""
    if c == 0:
        return np.zeros_like(v)
    out = GF_EXP[GF_LOG[c] + GF_LOG[np.maximum(v.astype(np.int32), 1)]]
    return np.where(v == 0, 0, out).astype(np.uint8)


def cauchy_matrix(k: int, p: int) -> np.ndarray:
    """The p x k parity rows: C[j][i] = 1/(x_j ^ y_i), x_j=k+j, y_i=i.
    Requires k + p <= 256 so all points are distinct in GF(256)."""
    if k < 1 or p < 0 or k + p > 256:
        raise ValueError(f"ec({k},{p}) outside GF(256)")
    out = np.zeros((p, k), np.uint8)
    for j in range(p):
        for i in range(k):
            out[j, i] = gf_inv((k + j) ^ i)
    return out


def gf_matmul_np(mat: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """(m, s) u8 matrix times (s, L) u8 cell rows over GF(256)."""
    m, s = mat.shape
    out = np.zeros((m, cells.shape[1]), np.uint8)
    for j in range(m):
        for i in range(s):
            out[j] ^= gf_mul_vec(int(mat[j, i]), cells[i])
    return out


def gf_matmul_torch(mat: np.ndarray, cells: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the `rs_matmul` kernel: (m, s) u8
    coefficients times (s, L) u8 cell rows over GF(2^8), on the device
    `cells` lies on. Carryless shift/xor on int32 lanes — each input row
    is doubled (x * 2 mod 0x11D) eight times and XORed into every output
    row whose coefficient has that bit set — so it is bit-exact with
    `gf_matmul_np` and with the kernel's product tables."""
    coef = np.asarray(mat, np.uint8)
    m, s = coef.shape
    if cells.shape[0] != s:
        raise ValueError(f"matrix is {coef.shape} but got {cells.shape[0]} "
                         "cell rows")
    out = torch.zeros((m, cells.shape[1]), dtype=torch.int32,
                      device=cells.device)
    for i in range(s):
        cur = cells[i].to(torch.int32)
        for bit in range(8):
            for j in range(m):
                if (int(coef[j, i]) >> bit) & 1:
                    out[j] ^= cur
            cur = ((cur << 1) & 0xFF) ^ (((cur >> 7) & 1) * 0x1D)
    return out.to(torch.uint8)


def gf_matinv_np(mat: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse over GF(256); raises on a singular matrix
    (cannot happen for survivor matrices of the Cauchy construction)."""
    n = mat.shape[0]
    a = mat.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r, col]), None)
        if piv is None:
            raise np.linalg.LinAlgError("singular GF(256) matrix")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            inv[[col, piv]] = inv[[piv, col]]
        scale = gf_inv(int(a[col, col]))
        a[col] = gf_mul_vec(scale, a[col])
        inv[col] = gf_mul_vec(scale, inv[col])
        for r in range(n):
            if r != col and a[r, col]:
                c = int(a[r, col])
                a[r] ^= gf_mul_vec(c, a[col])
                inv[r] ^= gf_mul_vec(c, inv[col])
    return inv


def decode_matrix(k: int, p: int, present: Sequence[int],
                  missing: Optional[Sequence[int]] = None) -> np.ndarray:
    """Rows reconstructing `missing` data cells from the k `present`
    cells (indices into the k+p stripe; parity cells are k..k+p-1).
    Returns (len(missing), k) u8 so reconstruction is one GF matmul."""
    present = list(present)
    if len(present) != k:
        raise ValueError(f"need exactly k={k} survivors, got {len(present)}")
    cauchy = cauchy_matrix(k, p)
    rows = np.zeros((k, k), np.uint8)
    for r, idx in enumerate(present):
        if idx < k:
            rows[r, idx] = 1
        else:
            rows[r] = cauchy[idx - k]
    inv = gf_matinv_np(rows)              # inv @ survivors = all data cells
    if missing is None:
        missing = [i for i in range(k) if i not in present]
    return inv[list(missing)]


def rs_encode_np(cells: np.ndarray, p: int) -> np.ndarray:
    """(k, L) u8 data cells -> (p, L) u8 parity cells."""
    return gf_matmul_np(cauchy_matrix(cells.shape[0], p), cells)


def rs_parity_delta_np(k: int, p: int, cells_idx: Sequence[int],
                       deltas: np.ndarray) -> np.ndarray:
    """Parity DELTAS for a partial-stripe overwrite (delta-parity RMW).

    The code is linear, so P'_j = P_j XOR sum_i C[j][i]*(old_i XOR new_i)
    over exactly the touched data cells i — a sub-cell overwrite updates
    parity from the touched cells' XOR deltas without ever reading the
    untouched k-|touched| cells. `deltas` is (len(cells_idx), L) u8 rows
    (old XOR new, media domain), `cells_idx` the touched data-cell stripe
    indices (< k). Returns (p, L) u8 rows to XOR onto the stored parity:
    XORing them in yields bit-exactly the full re-encode of the new
    stripe (the property test pins this)."""
    idx = list(cells_idx)
    if any(i < 0 or i >= k for i in idx):
        raise ValueError(f"touched cells {idx} outside data range 0..{k - 1}")
    if deltas.shape[0] != len(idx):
        raise ValueError(
            f"{deltas.shape[0]} delta rows for {len(idx)} touched cells")
    return gf_matmul_np(cauchy_matrix(k, p)[:, idx], deltas)


def rs_decode_np(survivors: np.ndarray, present: Sequence[int], k: int,
                 p: int,
                 missing: Optional[Sequence[int]] = None) -> np.ndarray:
    """Reconstruct missing data cells from any k survivors.

    survivors: (k, L) u8 rows ordered as `present` (stripe indices; parity
    cells are k..k+p-1). Returns (len(missing), L) u8 — by default every
    data cell NOT among the survivors, in ascending index order."""
    if missing is None:
        missing = [i for i in range(k) if i not in list(present)]
    return gf_matmul_np(decode_matrix(k, p, present, missing), survivors)


def erase_and_decode_np(cells: np.ndarray, p: int,
                        lost: Sequence[int]) -> np.ndarray:
    """Round-trip helper for tests: encode (k, L) data cells, erase the
    `lost` stripe indices, reconstruct the lost DATA cells from the first
    k survivors. Returns the reconstructed data rows for lost indices < k."""
    k = cells.shape[0]
    stripe = np.concatenate([cells, rs_encode_np(cells, p)], axis=0)
    present = [i for i in range(k + p) if i not in set(lost)][:k]
    missing = sorted(i for i in set(lost) if i < k)
    return rs_decode_np(stripe[present], present, k, p, missing)
