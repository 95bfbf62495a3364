"""Plain PyTorch version of the flash-attention forward kernel.

Materialises the full (T, S) score matrix — O(T*S) memory, fine at test
sizes — and applies exactly the kernel's masking semantics: causal by
absolute position, optional local window, optional logit softcap, kv
positions >= seq_k masked (padding), all with the finite mask value
-1e30. The counterpart of the reference's `attention_ref`
(`repro/kernels/flash_attention/ref.py:17`). The CPU tests use it and
chip_smoke.py holds the CUDA kernel against it on the card; nothing on the
card's main path calls it.
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
    qpos = torch.arange(T, device=q.device)[:, None]
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if seq_k is not None:
        mask = mask & (kpos < seq_k)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
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
