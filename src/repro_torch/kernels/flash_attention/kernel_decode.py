"""The `flash_decode` CUDA kernels (`csrc/flash_decode.cu`): binding, the
split of the sequence, and the launch.

Split-KV flash decoding on PyTorch's current stream: one query token a
sequence (q (B,1,H,D)) against its bf16 cache (k, v (B,S,KH,D)), keys at
positions >= kv_len[b] left out; out (B,1,H,D) in bf16. One call launches
two kernels, `flash_decode_split_kernel` (one CTA a batch row, kv head and
split of the sequence) and `flash_decode_combine_kernel` (the splits'
partials merged). It replaces no TPU kernel: the reference decodes on its
plain path. The source says what bounds it and what its design does about
that. The library is built from the repo's sources on first use
(`kernels/_build.py`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._launch import call_on, refuse_fake
from repro_torch.kernels.flash_attention.kernel import readable

HEAD_DIMS = (64, 128)
MAX_GROUP = 16          # query heads a kv head: the mma's 16 rows
TILE = 64               # positions a tile (the .cu's BN)
MAX_SPLITS = 32         # the .cu's MAX_SPLITS
MIN_TILES = 4           # tiles a split at least, so that a CTA streams
WAVES = 4               # split CTAs aimed at, in full waves of the card
SOURCE = "src/repro_torch/csrc/flash_decode.cu"
KERNEL_NAME = "flash_decode_"   # prefix of both __global__ functions
KERNELS_PER_CALL = 2
KV_LEN_DTYPES = (torch.int32, torch.int64)

_slots: Dict[Tuple[int, int], int] = {}   # (card, D) -> card_slots


def _bind(lib: ctypes.CDLL) -> None:
    i, p = ctypes.c_int, ctypes.c_void_p
    lib.flash_decode.argtypes = [
        i, i, i, i, i, p, p, p, p, p, p, p, ctypes.POINTER(ctypes.c_int64),
        ctypes.c_float, i, i, p]
    lib.flash_decode.restype = ctypes.c_int
    lib.flash_decode_ctas_per_sm.argtypes = [i]
    lib.flash_decode_ctas_per_sm.restype = ctypes.c_int


def _lib() -> ctypes.CDLL:
    return _build.load("flash_decode", ["flash_decode.cu"], _bind)


def build() -> None:
    """Build (or find) and load the library."""
    _lib()


def check_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor) -> None:
    """Raises on what the kernel does not take but the device, which the
    launch checks (its op's fake implementation checks a trace's tensors
    here)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise ValueError("flash_decode takes bfloat16 q, k, v, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if (T != 1 or D not in HEAD_DIMS or k.shape != (B, S, KH, D)
            or v.shape != k.shape or S < 1):
        raise ValueError(f"flash_decode takes q (B,1,H,D), D in {HEAD_DIMS},"
                         f" and k, v (B,S,KH,D); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if H % KH or H // KH > MAX_GROUP:
        raise ValueError(f"flash_decode takes groups of at most {MAX_GROUP} "
                         f"query heads a kv head, got H={H}, KH={KH}")
    if kv_len.shape != (B,) or kv_len.dtype not in KV_LEN_DTYPES:
        raise ValueError(f"flash_decode takes an int32 or int64 kv_len of "
                         f"shape ({B},), got {kv_len.dtype} "
                         f"{tuple(kv_len.shape)}")
    for x, what in ((q, "q"), (k, "k"), (v, "v")):
        readable(x, what, "flash_decode")


def plan(B: int, KH: int, S: int, slots: int) -> Tuple[int, int]:
    """(splits, tiles a split) for B x KH (batch row, kv head) pairs over
    S positions on a card that holds `slots` split CTAs at once: enough
    splits for WAVES full waves, none shorter than MIN_TILES tiles, at
    most MAX_SPLITS; no split left empty by the rounding."""
    tiles = -(-S // TILE)
    want = -(-WAVES * slots // (B * KH))
    n = max(1, min(want, tiles // MIN_TILES, MAX_SPLITS))
    per = -(-tiles // n)
    return -(-tiles // per), per


def card_slots(index: int, D: int) -> int:
    """Split CTAs card `index` holds at once at head dim D (the library's
    occupancy query times the SM count), read once a card."""
    got = _slots.get((index, D))
    if got is None:
        per_sm = call_on(index, lambda d, _stream:
                         _lib().flash_decode_ctas_per_sm(d), D)
        if per_sm < 1:
            raise RuntimeError(f"flash_decode_split_kernel fits no CTA on "
                               f"an SM of card {index} at D={D}")
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        got = _slots[(index, D)] = per_sm * sms
    return got


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *, scale: float) -> torch.Tensor:
    """q (B,1,H,D), k and v (B,S,KH,D) bfloat16 CUDA tensors, D in
    HEAD_DIMS, H / KH at most MAX_GROUP; kv_len (B,) int32 or int64 on the
    same card, each in 1..S (larger reads as S). Returns out (B,1,H,D) bf16.
    Raises on what the kernel does not take and if the launch fails."""
    refuse_fake("flash_decode", q, k, v, kv_len)
    dev = q.device
    if dev.type != "cuda" or any(x.device != dev for x in (k, v, kv_len)):
        raise ValueError("flash_decode takes CUDA tensors on one device, got "
                         f"{q.device}, {k.device}, {v.device}, "
                         f"{kv_len.device}")
    check_decode(q, k, v, kv_len)
    B, _, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    splits, per = plan(B, KH, S, card_slots(dev.index, D))
    if kv_len.dtype != torch.int32 or not kv_len.is_contiguous():
        kv_len = kv_len.to(torch.int32).contiguous()
    out = torch.empty((B, 1, H, D), dtype=torch.bfloat16, device=dev)
    part_o = torch.empty((B, KH, splits, H // KH, D), dtype=torch.float32,
                         device=dev)
    part_ml = torch.empty((B, KH, splits, H // KH, 2), dtype=torch.float32,
                          device=dev)
    strides = (ctypes.c_int64 * 8)(q.stride(0), q.stride(2), *k.stride()[:3],
                                   *v.stride()[:3])
    err = call_on(
        dev.index, _lib().flash_decode, B, S, H, KH, D, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
        part_o.data_ptr(), part_ml.data_ptr(), strides, float(scale), splits,
        per)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    return out
