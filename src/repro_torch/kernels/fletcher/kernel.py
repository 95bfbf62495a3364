"""The `fletcher` CUDA kernel (`csrc/fletcher.cu`): binding and launch.

[s1, s2] of the little-endian u32 words of a byte stream (the last word
zero-padded), on PyTorch's current stream. It replaces the TPU kernel
`repro/kernels/fletcher/kernel.py:56 fletcher_tiles`; the source says what
bounds it and what its design does about that. A call is one device
operation: the kernel adds its CTAs' sums into a pair that holds zeros,
and that pair is the next slot of a pool of POOL_PAIRS pairs, one pool a
card and stream, zeroed once when it is made, rather than a memset a
call. Each result is a (2,) view into its pool. The library is built from
the repo's sources on first use (`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Tuple

import torch

from repro_torch.kernels import _build, _launch

SOURCE = "src/repro_torch/csrc/fletcher.cu"
REPLACES = "src/repro/kernels/fletcher/kernel.py:56"
KERNEL_NAME = "fletcher_kernel"         # the __global__ function, as traced
POOL_PAIRS = 4096                       # zeroed [s1, s2] slots a pool

_pools: Dict[Tuple[int, int], List] = {}   # (card, stream) -> [pool, next]
_pools_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    lib.fletcher.argtypes = [p, ctypes.c_int64, p, p]
    lib.fletcher.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("fletcher", ["fletcher.cu"], _bind)


def build() -> None:
    """Build (or find) and load the library."""
    _lib()


def _zeroed_pair(index: int, stream: int) -> torch.Tensor:
    """The next pair of zeros of card `index`'s pool for `stream`. A new
    pool is zeroed on that stream, so the fill is ordered before every
    kernel that adds into it, and the allocator ties its memory to the
    stream that writes it."""
    with _pools_lock:
        slot = _pools.get((index, stream))
        if slot is None or slot[1] == POOL_PAIRS:
            pool = torch.zeros(POOL_PAIRS, 2, dtype=torch.int32,
                               device=torch.device("cuda", index))
            slot = _pools[(index, stream)] = [pool.view(torch.uint32), 0]
        k = slot[1]
        slot[1] = k + 1
    return slot[0][k]


def _launch_into_pair(x: torch.Tensor, stream: int) -> Tuple:
    out = _zeroed_pair(x.device.index, stream)
    return out, _lib().fletcher(x.data_ptr(), x.numel() * x.element_size(),
                                out.data_ptr(), stream)


def fletcher(x: torch.Tensor) -> torch.Tensor:
    """x: a contiguous, non-empty uint8 or uint32 CUDA tensor, read as its
    bytes. Returns (2,) uint32 [s1, s2] on x's device. Any start address
    works. Raises on what the kernel does not take and if the launch
    fails."""
    _launch.check_bytes(x, "fletcher")
    out, err = _launch.call_on(x.device.index, _launch_into_pair, x)
    if err != 0:
        raise RuntimeError(f"fletcher launch failed: CUDA error {err}")
    return out
