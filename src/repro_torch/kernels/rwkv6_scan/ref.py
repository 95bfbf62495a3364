"""Plain PyTorch versions of the RWKV6 WKV kernel, in float32.

`wkv_ref` is the sequential recurrence over T, the counterpart of the
reference's oracle (`repro/kernels/rwkv6_scan/ref.py:wkv_ref`); the
wrapper's backward is autograd through it, as the reference's custom_vjp
is `jax.vjp` of its oracle. `wkv_chunked_ref` is the chunk-parallel form
the kernel computes (`repro/models/rwkv.py:wkv_chunked`, with the chunk
given), under the model's plain path (`models/rwkv.py:wkv_chunked`).
`wkv_plain` is the kernel's plain version: the reference's chunk choice
and padding for its kernel, then `wkv_chunked_ref`. The wrapper runs it on
the CPU and chip_smoke.py holds the CUDA kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def wkv_ref(r, k, v, w, u, s0: Optional[torch.Tensor] = None):
    """r,k,v,w (B,T,H,hd); u (H,hd); s0 (B,H,hd,hd) or None. Returns
    (y (B,T,H,hd), final state (B,H,hd,hd)), float32."""
    B, T, H, hd = r.shape
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    ys = []
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]       # (B,H,hd,hd)
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, t], uf * kv + s))
        s = wf[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def wkv_chunked_ref(r, k, v, w, u, s0: Optional[torch.Tensor], chunk: int):
    """The chunk-parallel form over chunks of `chunk` steps (T % chunk ==
    0). Within a chunk, with lw = log(clip(w, 1e-12, 1)) and cum its
    inclusive cumulative sum:
      inter: y_t = (r_t * exp(cum_{t-1})) @ S
      intra: y_t += sum_{s<t} (r_t . k_s . exp(cum_{t-1} - cum_s)) v_s
             + (r_t * u . k_t) v_t
      state: S' = diag(exp(cum_C-1)) S + sum_s (exp(cum_C-1 - cum_s) k_s) v_s^T
    The pairwise exponent cum_{t-1} - cum_s is <= 0 for s < t, so strong
    decay cannot overflow (the factored exp(-cum) form does)."""
    B, T, H, hd = r.shape
    C = int(chunk)
    if C < 1 or T % C:
        raise ValueError(f"chunk {C} does not divide T={T}")
    n = T // C

    def chunks(x):                                   # (n, B, H, C, hd)
        return x.float().reshape(B, n, C, H, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc = chunks(r), chunks(k), chunks(v)
    lwc = chunks(torch.log(torch.clamp(w.float(), 1e-12, 1.0)))
    uf = u.float()[None, :, None, :]
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0.float())
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=r.device),
                     diagonal=-1)[:, :, None]
    ys = []
    for i in range(n):
        rt, kt, vt, lwt = rc[i], kc[i], vc[i], lwc[i]
        cum = torch.cumsum(lwt, dim=2)
        cum_prev = cum - lwt
        total = cum[:, :, -1:, :]
        y = torch.einsum("bhci,bhij->bhcj", rt * torch.exp(cum_prev), s)
        e = cum_prev[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,H,C,C,hd)
        e = torch.where(tri, e, -torch.inf)
        att = (rt[:, :, :, None, :] * kt[:, :, None, :, :]
               * torch.exp(e)).sum(-1)
        y = y + torch.einsum("bhcd,bhdj->bhcj", att, vt)
        y = y + (rt * uf * kt).sum(-1, keepdim=True) * vt
        k_dec = kt * torch.exp(total - cum)
        s = torch.exp(total)[:, :, 0, :, None] * s + torch.einsum(
            "bhci,bhcj->bhij", k_dec, vt)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, T, H, hd)
    return y, s


def wkv_plain(r, k, v, w, u, s0: Optional[torch.Tensor] = None,
              chunk: int = 32):
    """The kernel's function by the reference's route for its kernel
    (`repro/kernels/rwkv6_scan/ops.py:25-44`): the largest chunk <= `chunk`
    dividing T, or, where that falls under 8 with T > 8, `chunk` itself
    with T padded by w = 1 and r = k = v = 0 rows (which leave y and the
    state as they are); then `wkv_chunked_ref`."""
    T = r.shape[1]
    c = min(chunk, T)
    while T % c:
        c -= 1
    pad = 0
    if c < 8 and T > 8:                      # degenerate chunk; pad instead
        c = chunk
        pad = (-T) % c
    if pad:
        rows = (0, 0, 0, 0, 0, pad)
        r, k, v = (F.pad(x, rows) for x in (r, k, v))
        w = F.pad(w, rows, value=1.0)
    y, s = wkv_chunked_ref(r, k, v, w, u, s0, c)
    return y[:, :T], s
