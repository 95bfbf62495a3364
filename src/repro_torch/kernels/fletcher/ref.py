"""The numpy oracle and the plain PyTorch version of the Fletcher checksum.

Over N little-endian u32 words w_i (bytes zero-padded to a 4-byte
multiple):

    s1 = sum_i w_i              mod 2^32
    s2 = sum_i (N - i) * w_i    mod 2^32

packed as (s2 << 32) | s1. The storage engine's extent checksum
(`core/media.py fletcher64`) computes the same sums in numpy.

`fletcher_ref` and `fletcher_np` are the numpy oracle, from the
reference's `repro/kernels/fletcher/ref.py`. `fletcher_torch` is the CUDA
kernel's plain version on u32 words and `fletcher_checksum_torch` the
wrapper's on any dtype; the wrapper runs them on the CPU and chip_smoke.py
holds the kernel against them on the card. They compute in int64: each
product (N - i) * w_i is taken mod 2^32 through 16-bit halves (`mul32`,
below 2^49), so a sum of up to 2^31 of them stays below 2^63; longer
inputs are summed in chunks of that many words.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.stream_cipher.ref import (MASK32, int64_to_u32,
                                                   mul32, u32_to_int64)

CHUNK_WORDS = 1 << 31


def fletcher_ref(words: np.ndarray) -> np.ndarray:
    """words u32 (N,) -> (2,) u32 [s1, s2]."""
    w = words.astype(np.uint32)
    n = w.shape[0]
    with np.errstate(over="ignore"):
        weight = np.uint32(n & MASK32) - np.arange(n, dtype=np.uint32)
        s1 = int(w.sum(dtype=np.uint64)) & MASK32
        s2 = int((w * weight).sum(dtype=np.uint64)) & MASK32
    return np.array([s1, s2], np.uint32)


def fletcher_np(data: bytes) -> int:
    """numpy cross-check over raw bytes (pads to a u32 multiple); returns
    the packed 64-bit checksum (s2 << 32) | s1."""
    buf = np.frombuffer(data, np.uint8)
    pad = (-buf.size) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    w = buf.view(np.uint32).astype(np.uint64)
    n = w.size
    s1 = int(w.sum() & 0xFFFFFFFF)
    weight = (n - np.arange(n, dtype=np.uint64)) & 0xFFFFFFFF
    s2 = int((w * weight).sum() & 0xFFFFFFFF)
    return (s2 << 32) | s1


def fletcher_torch(words: torch.Tensor) -> torch.Tensor:
    """The plain version of the `fletcher` kernel: u32 words (N,) -> (2,)
    u32 [s1, s2] on the same device."""
    w = words.reshape(-1)
    n = w.numel()
    s1 = s2 = 0
    for start in range(0, n, CHUNK_WORDS):
        chunk = u32_to_int64(w[start:start + CHUNK_WORDS])
        weight = (n - torch.arange(start, start + chunk.numel(),
                                   dtype=torch.int64, device=w.device)) \
            & MASK32
        s1 = (s1 + chunk.sum()) & MASK32
        s2 = (s2 + mul32(chunk, weight).sum()) & MASK32
    return int64_to_u32(torch.stack([torch.as_tensor(s, device=w.device)
                                     for s in (s1, s2)]))


def as_bytes(x: torch.Tensor) -> torch.Tensor:
    """The bytes of any tensor in memory order, as a flat u8 tensor (a
    view where `x` is contiguous)."""
    flat = x if x.dim() == 1 else x.reshape(-1)
    if flat.dtype == torch.uint8:
        return flat
    if flat.numel() == 0:
        return torch.zeros(0, dtype=torch.uint8, device=flat.device)
    return flat.contiguous().view(torch.uint8)


def fletcher_checksum_torch(x: torch.Tensor) -> torch.Tensor:
    """The wrapper's semantics in plain PyTorch: the input's bytes in
    memory order (an element of 8 bytes gives two words, low half first;
    elements narrower than 4 bytes go through their bytes), zero-padded to
    a 4-byte multiple, as u32 words."""
    data = as_bytes(x)
    n = data.numel()
    padded = torch.zeros((n + 3) // 4 * 4, dtype=torch.uint8,
                         device=data.device)
    padded[:n] = data
    return fletcher_torch(padded.view(torch.uint32))
