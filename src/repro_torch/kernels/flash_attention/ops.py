"""Public wrapper for the flash-attention forward kernel.

`flash_attention` has the reference's semantics
(`repro/kernels/flash_attention/ops.py:106-124`): the scale defaults to
1/sqrt(D). On the CPU, T and S are padded to block multiples (bq =
min(block_q, max(8, T)), likewise bk), padded keys are masked through
seq_k and padded query rows dropped, as the reference pads for its kernel.
The CUDA kernel takes ragged T and S as they are (it masks keys past S and
writes no row past T), so on the card nothing is padded and block_q and
block_k have no effect: the kernel's tiles are its own.

A CUDA tensor goes to the hand-written `flash_attention_fwd` kernel — a
failed build or launch raises, nothing falls back — and a CPU tensor to
the plain PyTorch version `ref.attention_ref`. The kernel is forward-only:
on a CUDA tensor that requires grad the wrapper raises (the backward
kernel comes with the training slice). `LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128

LAUNCHES: Dict[str, int] = {"fwd": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        LAUNCHES["fwd"] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    return_lse: bool = False):
    """Flash attention. q (B,T,H,D); k,v (B,S,KH,D), H % KH == 0.

    Positions are absolute indices (q token t attends kv tokens <= t); for
    decode-style q offsets use the plain path (layers.attention), which
    takes a per-batch kv_len. Returns out (B,T,H,D) [, lse (B,H,T)].
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        T, S = q.shape[1], k.shape[1]
        bq = min(block_q, max(8, T))
        bk = min(block_k, max(8, S))
        out, lse = ref.attention_ref(
            _pad_to(q, 1, bq), _pad_to(k, 1, bk), _pad_to(v, 1, bk),
            scale=scale, causal=causal, window=window, softcap=softcap,
            seq_k=S, return_lse=True)
        out, lse = out[:, :T], lse[:, :, :T]
    else:
        if torch.is_grad_enabled() and any(
                x.requires_grad for x in (q, k, v)):
            raise RuntimeError(
                "flash_attention on the card is forward-only: the backward "
                "kernel (flash_attention_bwd) comes with the training slice")
        out, lse = K.flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                         window=window, softcap=softcap)
        with _launch_lock:
            LAUNCHES["fwd"] += 1
    return (out, lse) if return_lse else out
