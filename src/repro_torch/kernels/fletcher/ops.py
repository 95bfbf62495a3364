"""Public wrapper for the Fletcher checksum kernel.

`fletcher_checksum(x)` has the reference's semantics
(`repro/kernels/fletcher/ops.py:28-57`): the checksum [s1, s2] of an
array's u32 words, where u32 is taken as is, a dtype of 4 bytes or more
is bitcast in memory order (an 8-byte element gives two words, low half
first) and u8 and narrower dtypes go through their bytes, zero-padded to
a 4-byte multiple — on a little-endian card, all of them the input's
bytes in memory order, zero-padded. `packed` gives the engine's 64-bit
form (s2 << 32) | s1. `block` is the reference's tile width: it does not
change the result, and is only checked.

A tensor runs where it lies; a numpy array is placed on `device` (the
CUDA card unless the caller asks for the CPU). A CUDA tensor goes to the
hand-written kernel (`csrc/fletcher.cu`), which reads the bytes as they
lie, ragged or misaligned, so nothing is padded on the card; a failed
build or launch raises, nothing falls back. A CPU tensor goes to the
plain version `ref.fletcher_checksum_torch`. An empty input gives [0, 0]
without a launch, as the reference's oracle and the engine's
`media.fletcher64` do (the reference's wrapper raises there: its Pallas
grid would have no step). LAUNCHES["checksum"] counts kernel launches.
"""
from __future__ import annotations

import threading
from typing import Dict

import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels.fletcher import kernel as K
from repro_torch.kernels.fletcher import ref
from repro_torch.kernels.stream_cipher.ops import (DEFAULT_BLOCK, as_tensor,
                                                   check_block)

LAUNCHES: Dict[str, int] = {"checksum": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def fletcher_checksum(x, *, block: int = DEFAULT_BLOCK,
                      device: DeviceLike = None) -> torch.Tensor:
    """Checksum of any array's underlying words. Returns (2,) uint32
    [s1, s2] on the array's device."""
    check_block(block)
    data = ref.as_bytes(as_tensor(x, device))
    if data.numel() == 0:
        return torch.zeros(2, dtype=torch.int32,
                           device=data.device).view(torch.uint32)
    if data.device.type == "cpu":
        return ref.fletcher_checksum_torch(data)
    out = K.fletcher(data.contiguous())
    with _launch_lock:
        LAUNCHES["checksum"] += 1
    return out


def packed(csum: torch.Tensor) -> int:
    """[s1, s2] u32 -> int (s2 << 32) | s1 (as ref.fletcher_np)."""
    s1, s2 = (int(v) & ref.MASK32
              for v in csum.reshape(-1).view(torch.int32).tolist())
    return (s2 << 32) | s1
