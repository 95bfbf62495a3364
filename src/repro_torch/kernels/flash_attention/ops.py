"""Public wrapper for the flash-attention kernels, forward and backward.

`flash_attention` has the reference's semantics
(`repro/kernels/flash_attention/ops.py:106-124`): the scale defaults to
1/sqrt(D). On the CPU, T and S are padded to block multiples (bq =
min(block_q, max(8, T)), likewise bk), padded keys are masked through
seq_k and padded query rows dropped, as the reference pads for its kernel.
The CUDA kernels take ragged T and S as they are (they mask keys past S
and write no row past T), so on the card nothing is padded and block_q and
block_k have no effect: the kernels' tiles are their own.

It is differentiable, like the reference's custom_vjp: where grad is
enabled and q, k or v requires it, it runs as `_FlashAttention`, a
`torch.autograd.Function` whose forward is the forward above and whose
backward computes delta = rowsum(dout * out) in float32 and then dq, dk
and dv recomputed from lse, with dk and dv summed over each GQA group
(`flash_attention_backward`). A CUDA tensor goes to the hand-written
kernels `flash_attention_fwd` and `flash_attention_bwd` — a failed build
or launch raises, nothing falls back — and a CPU tensor to the plain
PyTorch versions in `ref`. Softcap keeps the reference's split
(`repro/kernels/flash_attention/ops.py:94-100`): its tanh derivative is
not in the backward kernel, so the softcap backward is autograd through
the plain `ref.attention_ref`, on either device, counted under
LAUNCHES["bwd_softcap"]. LAUNCHES["fwd"] and LAUNCHES["bwd"] count kernel
launches (one per call; the backward call launches its two kernels). A
call captured into a CUDA graph launches nothing and is not counted: each
replay of the graph launches the kernels it recorded.

The card's kernels are reached through two ops, `repro_torch::
flash_attention_fwd` and `repro_torch::flash_attention_bwd`
(`torch.library.custom_op`), which launch and count. Each has a fake
implementation, which runs the kernel's argument checks and makes its
outputs' shapes and dtypes, through which a trace under FakeTensorMode
(the dry-run's) passes without loading or launching anything, and a FLOP
formula registered with
`torch.utils.flop_counter` (`attention_flops`, which `chip_smoke.py`'s
bounds call too).

`flash_decode` is attention of one query token a sequence against a KV
cache with a per-row length (`kv_len`), the decode step's. A CUDA tensor
goes to the split-KV kernel (`kernel_decode`, through the op
`repro_torch::flash_decode`, which has a fake implementation and a FLOP
formula too) or the call raises; a CPU tensor to `ref.decode_ref`, which
is bit for bit what the plain path of `models/layers.py` `attention`
computes. `decode_takes` says which calls `attention` sends there.
LAUNCHES["decode"] counts the op's calls on the card, a call captured into
a CUDA graph included (each replay of the graph then launches what the
capture recorded), and LAUNCHES["decode_plain"] the decode calls on the
card that asked for "flash" and that `decode_takes` left on the plain path.
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._launch import launching
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import kernel_bwd as KB
from repro_torch.kernels.flash_attention import kernel_decode as KD
from repro_torch.kernels.flash_attention import ref

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128

LAUNCHES: Dict[str, int] = {"fwd": 0, "bwd": 0, "bwd_softcap": 0,
                            "decode": 0, "decode_plain": 0}
_launch_lock = threading.Lock()


def _count(key: str) -> None:
    with _launch_lock:
        LAUNCHES[key] += 1


def reset_launches() -> None:
    with _launch_lock:
        for key in LAUNCHES:
            LAUNCHES[key] = 0


def launches() -> Dict[str, int]:
    with _launch_lock:
        return dict(LAUNCHES)


def attention_pairs(T: int, S: int, causal: bool = True,
                    window: Optional[int] = None,
                    seq_k: Optional[int] = None) -> int:
    """The (query, key) pairs attention computes for queries 0..T-1 over
    keys 0..S-1: keys below seq_k (default S), at or before the query
    where causal, after query - window where a window is set (the plain
    version's mask, `ref._mask`)."""
    lim = S if seq_k is None else min(S, seq_k)
    t = np.arange(T, dtype=np.int64)
    hi = np.minimum(t + 1, lim) if causal else np.full(T, lim)
    lo = np.maximum(t - window + 1, 0) if window is not None else 0
    return int(np.clip(hi - lo, 0, None).sum())


def attention_flops(B: int, T: int, S: int, H: int, D: int, *,
                    causal: bool = True, window: Optional[int] = None,
                    seq_k: Optional[int] = None,
                    backward: bool = False) -> int:
    """The flash kernels' FLOPs on q (B,T,H,D) against S keys: 4·D a
    computed (query, key) pair forward (q·k and p·v, two each), 10·D
    backward (its five products)."""
    return ((10 if backward else 4) * D * B * H
            * attention_pairs(T, S, causal, window, seq_k))


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return F.pad(x, widths)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _fwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                scale: float, causal: bool, window: Optional[int],
                softcap: Optional[float]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel's launch, counted."""
    out, lse = K.flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                     window=window, softcap=softcap)
    if launching():
        _count("fwd")
    return out, lse


@_fwd_kernel.register_fake
def _(q, k, v, scale, causal, window, softcap):
    K.check_fwd(q, k, v, window, softcap)
    B, T, H, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((B, H, T), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _(q, k, v, scale, causal, window, softcap, *args, **kwargs) -> int:
    B, T, H, D = q
    return attention_flops(B, T, k[1], H, D, causal=causal, window=window)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _bwd_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                dout: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                scale: float, causal: bool, window: Optional[int]
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' launch, counted."""
    grads = KB.flash_attention_bwd(q, k, v, dout, lse, delta, scale=scale,
                                   causal=causal, window=window)
    if launching():
        _count("bwd")
    return grads


@_bwd_kernel.register_fake
def _(q, k, v, dout, lse, delta, scale, causal, window):
    KB.check_bwd(q, k, v, dout, lse, delta, window)
    return tuple(torch.empty_like(x, memory_format=torch.contiguous_format)
                 for x in (q, k, v))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _(q, k, v, dout, lse, delta, scale, causal, window, *args,
      **kwargs) -> int:
    B, T, H, D = q
    return attention_flops(B, T, k[1], H, D, causal=causal, window=window,
                           backward=True)


@torch.library.custom_op("repro_torch::flash_decode", mutates_args=())
def _decode_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """The decode kernels' launch, counted (at capture too)."""
    out = KD.flash_decode(q, k, v, kv_len, scale=scale)
    _count("decode")
    return out


@_decode_kernel.register_fake
def _(q, k, v, kv_len, scale):
    KD.check_decode(q, k, v, kv_len)
    return q.new_empty(q.shape)


@register_flop_formula(torch.ops.repro_torch.flash_decode)
def _(q, k, v, kv_len, scale, *args, **kwargs) -> int:
    B, T, H, D = q
    # kv_len is data: every cached position, as the plain path's einsums
    return attention_flops(B, T, k[1], H, D, causal=False)


def decode_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: Optional[torch.Tensor], *, causal: bool,
                 window: Optional[int], softcap: Optional[float]) -> bool:
    """Whether `flash_decode` computes this attention call: one query
    token against a cache of per-row length kv_len (B,), no causal mask,
    window or softcap, bfloat16 q, k, v of one head dim in
    kernel_decode.HEAD_DIMS, at most MAX_GROUP query heads a kv head."""
    B, T, H, D = q.shape
    return (kv_len is not None and T == 1 and not causal and window is None
            and not softcap and D in KD.HEAD_DIMS and v.shape[-1] == D
            and k.shape[-1] == D
            and all(x.dtype == torch.bfloat16 for x in (q, k, v))
            and H % k.shape[2] == 0 and H // k.shape[2] <= KD.MAX_GROUP
            and tuple(kv_len.shape) == (B,)
            and kv_len.dtype in KD.KV_LEN_DTYPES)


def note_plain_decode(q: torch.Tensor) -> None:
    """Counts a decode call on the card that asked for "flash" and that
    `decode_takes` left on the plain path."""
    if q.is_cuda:
        _count("decode_plain")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_len: torch.Tensor, *,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Attention of q (B,1,H,D) over k, v (B,S,KH,D) at positions below
    kv_len (B,), scale default 1/sqrt(D): the kernel on a CUDA tensor
    (raising on what it does not take), `ref.decode_ref` on a CPU one.
    Returns (B,1,H,D) in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return ref.decode_ref(q, k, v, kv_len, float(scale))
    return torch.ops.repro_torch.flash_decode(q, k, v, kv_len, float(scale))


def _forward(q, k, v, scale, causal, window, softcap, block_q, block_k):
    """(out, lse) of the forward on q's device."""
    if q.device.type == "cpu":
        T, S = q.shape[1], k.shape[1]
        bq = min(block_q, max(8, T))
        bk = min(block_k, max(8, S))
        out, lse = ref.attention_ref(
            _pad_to(q, 1, bq), _pad_to(k, 1, bk), _pad_to(v, 1, bk),
            scale=scale, causal=causal, window=window, softcap=softcap,
            seq_k=S, return_lse=True)
        return out[:, :T], lse[:, :, :T]
    return torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, scale, causal, window, softcap)


def flash_attention_backward(q, k, v, out, lse, dout, *, scale: float,
                             causal: bool = True,
                             window: Optional[int] = None):
    """dq, dk, dv of flash attention without softcap, from the forward's
    out and lse: the backward kernel on a CUDA tensor, the plain version
    on a CPU one. dk and dv are summed over each GQA group, as the
    reference reduces its per-head kernel outputs
    (`repro/kernels/flash_attention/ops.py:88-90`)."""
    if q.device.type == "cpu":
        dq, dk, dv = ref.flash_attention_bwd_ref(
            q, k, v, out, lse, dout, scale=scale, causal=causal,
            window=window, seq_k=k.shape[1])
    else:
        # delta in float32 outside the kernel, as the reference computes it
        # (repro/kernels/flash_attention/kernel_bwd.py:140-141)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
        dq, dk, dv = torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, dout.contiguous(), lse.contiguous(),
            delta.contiguous(), scale, causal, window)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _softcap_backward(q, k, v, dout, *, scale, causal, window, softcap):
    """The reference's softcap split: autograd through the plain version."""
    with torch.enable_grad():
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        out = ref.attention_ref(*qkv, scale=scale, causal=causal,
                                window=window, softcap=softcap)
        grads = torch.autograd.grad(out, qkv, dout)
    _count("bwd_softcap")
    return grads


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its backward: returns (out, lse); lse carries
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, softcap, block_q,
                block_k):
        out, lse = _forward(q, k, v, scale, causal, window, softcap,
                            block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, softcap)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window, softcap = ctx.args
        if softcap is None:
            grads = flash_attention_backward(q, k, v, out, lse, dout,
                                             scale=scale, causal=causal,
                                             window=window)
        else:
            grads = _softcap_backward(q, k, v, dout, scale=scale,
                                      causal=causal, window=window,
                                      softcap=softcap)
        return (*grads, None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK_Q,
                    block_k: int = DEFAULT_BLOCK_K,
                    return_lse: bool = False):
    """Flash attention. q (B,T,H,D); k,v (B,S,KH,D), H % KH == 0.

    Positions are absolute indices (q token t attends kv tokens <= t); a
    decode step's query against a cache of per-row length goes to
    `flash_decode`. Returns out (B,T,H,D) [, lse (B,H,T)].
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    args = (float(scale), bool(causal), window, softcap, int(block_q),
            int(block_k))
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        out, lse = _FlashAttention.apply(q, k, v, *args)
    else:
        out, lse = _forward(q, k, v, *args)
    return (out, lse) if return_lse else out
