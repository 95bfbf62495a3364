"""The numpy oracle and the plain PyTorch version of the stream cipher.

Word j of a u32 stream is XORed with

    ks(j) = fmix32((j + nonce) * 0x9E3779B9 + key)      all mod 2^32
    fmix32: x ^= x >> 16; x *= 0x85EBCA6B; x ^= x >> 13;
            x *= 0xC2B2AE35; x ^= x >> 16

(the murmur3 finalizer). Applying it twice restores the input. The
storage path's `core/smartnic.py InlineCrypto` computes the same PRF in
numpy, so bytes it encrypts decrypt here and on the card.

`keystream_u32` and `cipher_ref` are the numpy oracle, copied from the
reference's `repro/kernels/stream_cipher/ref.py`. `cipher_torch` is the
CUDA kernel's plain version on u32 words, and `stream_cipher_torch` the
wrapper's on u8 or u32 input; the wrapper runs them on the CPU and
chip_smoke.py holds the kernel against them on the card. torch has
`uint32` storage but little arithmetic for it, so they compute in int64
and mask to 32 bits. A product of two u32 values would reach 2^64 and
overflow int64, so each multiply by a constant goes through its 16-bit
halves (`mul32`), which keeps every intermediate below 2^49.
"""
from __future__ import annotations

import numpy as np
import torch

GOLDEN32 = 0x9E3779B9
MASK32 = 0xFFFFFFFF


def keystream_u32(idx: np.ndarray, key: int, nonce: int) -> np.ndarray:
    """The PRF over u32 word indices `idx` (numpy, wrapping mod 2^32)."""
    with np.errstate(over="ignore"):
        x = (idx.astype(np.uint32) + np.uint32(nonce & MASK32)) \
            * np.uint32(GOLDEN32) + np.uint32(key & MASK32)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x85EBCA6B)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(0xC2B2AE35)
        x = x ^ (x >> np.uint32(16))
    return x


def cipher_ref(words: np.ndarray, key: int, nonce: int) -> np.ndarray:
    """words u32 (N,) -> XOR with the murmur3-finalizer keystream."""
    idx = np.arange(words.shape[0], dtype=np.uint32)
    return words.astype(np.uint32) ^ keystream_u32(idx, key, nonce)


def mul32(x: torch.Tensor, c) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x and c in [0, 2^32) (an int or an int64
    tensor), without an intermediate at or above 2^49."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def keystream_torch(n_words: int, key: int, nonce: int,
                    device) -> torch.Tensor:
    """ks(j) for j in [0, n_words), int64 in [0, 2^32). Word indices stay
    int64, so a stream of 2^28 words and more indexes without wrap;
    `+ nonce` wraps mod 2^32 as the reference's u32 add does."""
    idx = torch.arange(n_words, dtype=torch.int64, device=device)
    x = (idx + (nonce & MASK32)) & MASK32
    x = (mul32(x, GOLDEN32) + (key & MASK32)) & MASK32
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def u32_to_int64(words: torch.Tensor) -> torch.Tensor:
    """u32 tensor -> int64 in [0, 2^32), through int32 (whose ops every
    device has)."""
    return words.view(torch.int32).to(torch.int64) & MASK32


def int64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> u32 tensor, through the int32 of the same
    bits (an exact conversion, no wrap left to the cast)."""
    return (x - ((x >> 31) << 32)).to(torch.int32).view(torch.uint32)


def cipher_torch(words: torch.Tensor, key: int, nonce: int) -> torch.Tensor:
    """The plain version of the `stream_cipher` kernel: u32 words (N,) ->
    u32 (N,) on the same device, word j XORed with ks(j)."""
    w = u32_to_int64(words.reshape(-1))
    ks = keystream_torch(w.numel(), key, nonce, w.device)
    return int64_to_u32(w ^ ks)


def stream_cipher_torch(x: torch.Tensor, key: int,
                        nonce: int) -> torch.Tensor:
    """The wrapper's semantics in plain PyTorch: u32 input flattened; u8
    input zero-padded to a 4-byte multiple, read as little-endian u32
    words, ciphered and cut back to its n bytes."""
    flat = x.reshape(-1)
    if flat.dtype == torch.uint32:
        return cipher_torch(flat, key, nonce)
    if flat.dtype != torch.uint8:
        raise TypeError(f"stream_cipher takes uint8 or uint32, got {x.dtype}")
    n = flat.numel()
    padded = torch.zeros((n + 3) // 4 * 4, dtype=torch.uint8,
                         device=flat.device)
    padded[:n] = flat
    return cipher_torch(padded.view(torch.uint32), key,
                        nonce).view(torch.uint8)[:n]
