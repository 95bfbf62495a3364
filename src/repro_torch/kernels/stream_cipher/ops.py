"""Public wrapper for the stream-cipher kernel.

`stream_cipher(x, key, nonce)` has the reference's semantics
(`repro/kernels/stream_cipher/ops.py:17-48`): a u32 input is flattened
and word j XORed with the keystream ks(j) of (key, nonce); a u8 input is
zero-padded to a 4-byte multiple, read as little-endian u32 words and cut
back to its n bytes; any other dtype raises. Applying it twice restores
the input. `block` is the reference's tile width: it does not change the
result, and is only checked.

A tensor runs where it lies; a numpy array is placed on `device` (the
CUDA card unless the caller asks for the CPU). A CUDA tensor goes to the
hand-written kernel (`csrc/stream_cipher.cu`), which reads a ragged or
misaligned u8 stream as it is, so nothing is padded on the card; a failed
build or launch raises, nothing falls back. A CPU tensor goes to the
plain version `ref.stream_cipher_torch`. An empty input returns an empty
result without a launch, as the reference's oracle does (the reference's
wrapper raises there: its Pallas grid would have no step).
LAUNCHES["cipher"] counts kernel launches.
"""
from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.stream_cipher import kernel as K
from repro_torch.kernels.stream_cipher import ref

DEFAULT_BLOCK = 2048
LAUNCHES: Dict[str, int] = {"cipher": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def as_tensor(x, device: DeviceLike) -> torch.Tensor:
    """A tensor on the op's device: a tensor stays where it lies unless
    `device` names another; a numpy array goes to `device`."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    dev = resolve_device(device)
    arr = np.ascontiguousarray(x)
    if not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr).to(dev)


def check_block(block: int) -> None:
    if int(block) < 1:
        raise ValueError(f"block must be a positive word count, got {block}")


def stream_cipher(x, key: int, nonce: int, *, block: int = DEFAULT_BLOCK,
                  device: DeviceLike = None) -> torch.Tensor:
    """XOR-cipher a u32 (or u8) array; returns a flat tensor of its dtype
    on its device. Involution: stream_cipher(stream_cipher(x)) == x."""
    check_block(block)
    x = as_tensor(x, device)
    if x.dtype not in (torch.uint8, torch.uint32):
        raise TypeError(f"stream_cipher takes uint8 or uint32, got {x.dtype}")
    flat = x if x.dim() == 1 else x.reshape(-1)
    if flat.numel() == 0:
        return flat.clone()
    if flat.device.type == "cpu":
        return ref.stream_cipher_torch(flat, key, nonce)
    out = K.cipher(flat.contiguous(), key, nonce)
    with _launch_lock:
        LAUNCHES["cipher"] += 1
    return out
