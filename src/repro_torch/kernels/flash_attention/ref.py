"""Plain PyTorch versions of the flash-attention kernels, forward and
backward.

Materialises the full (T, S) score matrix — O(T*S) memory, fine at test
sizes — and applies exactly the kernel's masking semantics: causal by
absolute position, optional local window, optional logit softcap, kv
positions >= seq_k masked (padding), all with the finite mask value
-1e30. `attention_ref` is the counterpart of the reference's
(`repro/kernels/flash_attention/ref.py:17`); `flash_attention_bwd_ref` is
the recompute-from-lse math of the reference's backward kernels
(`repro/kernels/flash_attention/kernel_bwd.py:32-49`, `_tile_p_ds`) over
whole tensors. `decode_ref` is the decode kernel's plain version: the
plain path of `models/layers.py` `attention` for one query token against a
cache with a per-row length, op for op, so that a CPU call of
`flash_decode` gives what that path gives, bit for bit. The CPU tests use
them and chip_smoke.py holds the CUDA kernels against them on the card; on
the card's main path only the softcap backward (autograd through
`attention_ref`) reaches this module.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

MASK_VALUE = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: Optional[float] = None, causal: bool = True,
                  window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  seq_k: Optional[int] = None,
                  return_lse: bool = False):
    """q (B,T,H,D); k,v (B,S,KH,Dv). Returns (B,T,H,Dv) [, lse (B,H,T)]."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    qg = qf.reshape(B, T, KH, G, D)
    s = torch.einsum("btkgd,bskd->bkgts", qg, kf)          # (B,KH,G,T,S)
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    mask = _mask(T, S, causal, window, seq_k, q.device)
    s = torch.where(mask, s, torch.tensor(MASK_VALUE, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->bkgtd", p / l.clamp_min(1e-30), vf)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, H, -1).to(q.dtype)
    if return_lse:
        lse = (m + torch.log(l.clamp_min(1e-30)))[..., 0]   # (B,KH,G,T)
        return out, lse.reshape(B, H, T)
    return out


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               kv_len: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,1,H,D); k, v (B,S,KH,D); keys at positions >= kv_len[b]
    masked. The plain path's arithmetic in its order: q times the scale
    in q's dtype, float32 scores and softmax over the whole cache as one
    chunk, p rounded to v's dtype for p.v, out in q's dtype. Returns
    (B,1,H,D)."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    dev = q.device
    qgf = (q.reshape(B, T, KH, G, D)
           * torch.tensor(scale, dtype=q.dtype)).float()
    neg = torch.full((), MASK_VALUE, dtype=torch.float32, device=dev)
    m = torch.full((B, KH, G, T), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KH, G, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, G, T, D), dtype=torch.float32, device=dev)
    s = torch.einsum("btkgd,bskd->bkgts", qgf, k.float())
    valid = torch.arange(S, device=dev)[None, :] < kv_len.reshape(-1, 1)
    live = (torch.ones((T, S), dtype=torch.bool, device=dev)[None, None, None]
            & valid[:, None, None, None, :])
    s = torch.where(live, s, neg)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bkgts,bskd->bkgtd", p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D).to(q.dtype)


def _mask(T: int, S: int, causal: bool, window: Optional[int],
          seq_k: Optional[int], device) -> torch.Tensor:
    qpos = torch.arange(T, device=device)[:, None]
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if seq_k is not None:
        mask = mask & (kpos < seq_k)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            scale: float, causal: bool,
                            window: Optional[int], seq_k: int):
    """The backward recomputed from lse: q, out, dout (B,T,H,D); k, v
    (B,S,KH,D); lse (B,H,T). With delta = rowsum(dout * out),
    p = exp(mask(scale q.k) - lse), ds = p * (dout.v - delta) * scale:
    returns float32 dq = ds.k (B,T,H,D) and dk = ds^T.q, dv = p^T.dout
    (B,S,KH,D), summed over each GQA group, as the CUDA kernel returns
    them."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    G = H // KH
    qf = q.float().reshape(B, T, KH, G, D)
    kf, vf = k.float(), v.float()
    dof = dout.float().reshape(B, T, KH, G, D)
    delta = (dout.float() * out.float()).sum(-1)             # (B,T,H)
    delta = delta.reshape(B, T, KH, G).permute(0, 2, 3, 1)[..., None]
    lse = lse.float().reshape(B, KH, G, T)[..., None]         # (B,KH,G,T,1)
    s = torch.einsum("btkgd,bskd->bkgts", qf * scale, kf)    # (B,KH,G,T,S)
    mask = _mask(T, S, causal, window, seq_k, q.device)
    s = torch.where(mask, s, torch.tensor(MASK_VALUE, device=q.device))
    p = torch.exp(s - lse)                                    # masked -> 0
    dp = torch.einsum("btkgd,bskd->bkgts", dof, vf)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bkgts,bskd->btkgd", ds, kf).reshape(B, T, H, D)
    dk = torch.einsum("bkgts,btkgd->bskd", ds, qf)
    dv = torch.einsum("bkgts,btkgd->bskd", p, dof)
    return dq, dk, dv
