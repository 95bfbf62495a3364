"""Public wrappers for the GF(256) Reed-Solomon parity kernel.

`ec_encode` / `ec_decode` are the two legs the data path uses: the write
fan-out encodes k data cells into p parity cells, and degraded reads /
rebuild reconstruct missing data cells from any k survivors;
`ec_parity_delta` serves the delta-parity RMW. Coefficient matrices come
from the numpy oracle (ref.py — table math is cheap at (k, p) scale) and
ride to the kernel by value, so every stripe and every survivor subset is
one launch.

Inputs are u8 tensors or arrays. A tensor runs where it lies; an array is
placed on `device` (the CUDA card unless the caller asks for the CPU).
A CUDA tensor goes to the `rs_matmul` kernel — a failed build or launch
raises, nothing falls back — and a CPU tensor to the plain PyTorch
version `ref.gf_matmul_torch`. Results are u8 tensors on the input's
device. `LAUNCHES` counts kernel launches by leg.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, device_of
from repro_torch.kernels.rs_parity import kernel as K
from repro_torch.kernels.rs_parity import ref

LAUNCHES: Dict[str, int] = {"encode": 0, "delta": 0, "decode": 0,
                            "matmul": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for leg in LAUNCHES:
            LAUNCHES[leg] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def _as_u8(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.uint8)
    arr = np.ascontiguousarray(x, np.uint8)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def _gf_matmul(mat: np.ndarray, cells: torch.Tensor,
               leg: str) -> torch.Tensor:
    m, s = mat.shape
    if cells.shape[0] != s:
        raise ValueError(f"matrix is {mat.shape} but got {cells.shape[0]} "
                         "cell rows")
    if m == 0 or cells.shape[1] == 0:
        return torch.zeros((m, cells.shape[1]), dtype=torch.uint8,
                           device=cells.device)
    if cells.device.type == "cpu":
        return ref.gf_matmul_torch(mat, cells)
    out = K.rs_matmul(mat, cells.contiguous())
    with _launch_lock:
        LAUNCHES[leg] += 1
    return out


def gf_matmul(mat, cells, *, device: DeviceLike = None) -> torch.Tensor:
    """(m, s) u8 GF coefficient matrix times (s, L) u8 cell rows."""
    return _gf_matmul(np.asarray(mat, np.uint8),
                      _as_u8(cells, device_of(cells, device)), "matmul")


def ec_encode(cells, p: int, *, device: DeviceLike = None) -> torch.Tensor:
    """(k, L) u8 data cells -> (p, L) u8 Reed-Solomon parity cells."""
    cells = _as_u8(cells, device_of(cells, device))
    return _gf_matmul(ref.cauchy_matrix(cells.shape[0], p), cells, "encode")


def ec_parity_delta(k: int, p: int, cells_idx: Sequence[int], deltas, *,
                    device: DeviceLike = None) -> torch.Tensor:
    """Parity deltas for a partial-stripe overwrite (delta-parity RMW).

    GF(256) linearity: P'_j = P_j XOR sum_i C[j][i]*(old_i XOR new_i)
    over exactly the touched data cells, so a sub-stripe write updates
    parity without reading the untouched cells. `deltas` is
    (len(cells_idx), L) u8 rows of old XOR new media bytes; `cells_idx`
    the touched data-cell stripe indices (< k). Returns (p, L) u8 rows
    the parity targets XOR onto their stored cells (the engine-side
    `xor_apply` op) — bit-exact against a full re-encode. Same kernel as
    `ec_encode` with the Cauchy column submatrix."""
    idx = list(cells_idx)
    if any(i < 0 or i >= k for i in idx):
        raise ValueError(f"touched cells {idx} outside data range 0..{k - 1}")
    deltas = _as_u8(deltas, device_of(deltas, device))
    if deltas.shape[0] != len(idx):
        raise ValueError(
            f"{deltas.shape[0]} delta rows for {len(idx)} touched cells")
    return _gf_matmul(np.ascontiguousarray(ref.cauchy_matrix(k, p)[:, idx]),
                      deltas, "delta")


def ec_decode(survivors, present: Sequence[int], k: int, p: int,
              missing: Optional[Sequence[int]] = None, *,
              device: DeviceLike = None) -> torch.Tensor:
    """Reconstruct missing data cells from any k surviving cells.

    survivors: (k, L) u8 rows ordered as `present` (stripe indices 0..k+p-1,
    parity cells are k..). Returns (len(missing), L) u8 — by default every
    data cell not among the survivors, ascending."""
    if missing is None:
        missing = [i for i in range(k) if i not in list(present)]
    survivors = _as_u8(survivors, device_of(survivors, device))
    if not missing:
        return torch.zeros((0, survivors.shape[1]), dtype=torch.uint8,
                           device=survivors.device)
    return _gf_matmul(ref.decode_matrix(k, p, present, missing), survivors,
                      "decode")
