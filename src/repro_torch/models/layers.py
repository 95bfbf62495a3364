"""Shared layer library: norms, rotary, attention variants, MLPs, losses.

Plain PyTorch, the counterpart of `repro/models/layers.py`. The hot spots
with hand-written kernels are prefill self-attention and decode attention
over the cache (`attention` with impl="flash"); everything else is plain
torch, as the reference leaves it to XLA. `sharded_mlp` and
`softmax_xent` with a MeshCtx are the tensor-parallel forms a rank runs on
its shards (`models/context.py`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.models.context import (MeshCtx, copy_to_model, gather_fsdp,
                                        reduce_from_model)


# ---------------------------------------------------------------------------
# Norms

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * w.to(dt)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dt) * w.to(dt) + b.to(dt)


# ---------------------------------------------------------------------------
# Rotary embeddings

def rope_freqs(positions: torch.Tensor, dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., dim//2)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., T, H, D); cos/sin (T, D//2) or broadcastable: prefill gives
    (T, D//2), decode (B, 1, D//2); both broadcast over the head dim."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    dt = x.dtype
    x1f, x2f = x1.float(), x2.float()
    return torch.cat([x1f * c - x2f * s, x2f * c + x1f * s], dim=-1).to(dt)


# ---------------------------------------------------------------------------
# Attention
#
# q: (B, T, H, D);  k, v: (B, S, KH, D), H % KH == 0 (GQA group G = H // KH).
# Causal/local masking by absolute positions. Chunked online-softmax over the
# KV axis keeps peak memory at B*H*T*chunk for long prefill.


def _pick_chunk(s: int, target: int = 1024) -> int:
    for c in (target, 512, 256, 128, 64):
        if s % c == 0 and c <= s:
            return c
    return s


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              q_positions: torch.Tensor,
              kv_positions: torch.Tensor,
              causal: bool = True,
              window: Optional[int] = None,
              kv_len: Optional[torch.Tensor] = None,
              softmax_scale: Optional[float] = None,
              chunk: Optional[int] = None,
              logit_softcap: Optional[float] = None,
              impl: str = "jnp") -> torch.Tensor:
    """Grouped-query attention with online softmax over KV chunks.

    kv_len: optional per-batch valid length of the kv cache (decode).
    window: local attention window (positions within [qpos-window+1, qpos]).
    impl="flash" dispatches to the flash-attention kernel when the call is a
    plain self-attention (no dynamic kv_len, D == Dv, T == S) — the shape
    prefill serves — and to the decode kernel (`flash_decode`) when it is
    one query token against a cache of per-row length kv_len that
    `decode_takes` accepts (bfloat16, no mask but kv_len, head dim 64 or
    128); other decode calls keep the plain path below, and on the card
    are counted as such. ("jnp" names the plain path, as in the
    reference's configs.) Returns (B, T, H, D).
    """
    B, T, H, D = q.shape
    if (impl == "flash" and kv_len is None and v.shape[-1] == D
            and T == k.shape[1]):
        from repro_torch.kernels.flash_attention.ops import flash_attention
        return flash_attention(q, k, v, scale=softmax_scale, causal=causal,
                               window=window, softcap=logit_softcap)
    if impl == "flash" and kv_len is not None:
        from repro_torch.kernels.flash_attention import ops as fops
        if fops.decode_takes(q, k, v, kv_len, causal=causal, window=window,
                             softcap=logit_softcap):
            return fops.flash_decode(q, k, v, kv_len, scale=softmax_scale)
        fops.note_plain_decode(q)
    S, KH = k.shape[1], k.shape[2]
    Dv = v.shape[-1]                      # may differ from D (e.g. MLA)
    G = H // KH
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, T, KH, G, D) * torch.tensor(scale, dtype=q.dtype)
    # the reference's einsums take preferred_element_type=float32: products
    # of the compute dtype summed in float32, which float32 operands give
    qgf = qg.float()

    csize = chunk or _pick_chunk(S)
    n_chunks = S // csize
    if n_chunks * csize != S:
        raise ValueError(f"chunk {csize} does not divide kv length {S}")

    dev = q.device
    # a fill on the device, not a copy from the host, so that a CUDA graph
    # can capture it
    neg = torch.full((), -1e30, dtype=torch.float32, device=dev)
    m = torch.full((B, KH, G, T), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KH, G, T), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, KH, G, T, Dv), dtype=torch.float32, device=dev)
    for i in range(n_chunks):
        sl = slice(i * csize, (i + 1) * csize)
        ks, vs, ps = k[:, sl], v[:, sl], kv_positions[sl]
        s = torch.einsum("btkgd,bskd->bkgts", qgf, ks.float())
        if logit_softcap:
            s = torch.tanh(s / logit_softcap) * logit_softcap
        mask = torch.ones((T, csize), dtype=torch.bool, device=dev)
        if causal:
            mask &= ps[None, :] <= q_positions[:, None]
        if window is not None:
            mask &= ps[None, :] > q_positions[:, None] - window
        m_full = mask[None, None, None]            # (1,1,1,T,C)
        if kv_len is not None:
            idx = i * csize + torch.arange(csize, device=dev)
            valid = idx[None, :] < kv_len.reshape(-1, 1)     # (B or 1, C)
            m_full = m_full & valid[:, None, None, None, :]
        s = torch.where(m_full, s, neg)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgts,bskd->bkgtd", p.to(vs.dtype).float(), vs.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    # (B, KH, G, T, Dv) -> (B, T, KH, G, Dv) -> (B, T, H, Dv)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, Dv).to(q.dtype)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    softmax_scale: Optional[float] = None) -> torch.Tensor:
    """Unmasked attention (encoder-decoder / vision cross-attn)."""
    T, S = q.shape[1], k.shape[1]
    return attention(
        q, k, v,
        q_positions=torch.zeros((T,), dtype=torch.int32, device=q.device),
        kv_positions=torch.zeros((S,), dtype=torch.int32, device=q.device),
        causal=False, softmax_scale=softmax_scale)


# ---------------------------------------------------------------------------
# MLPs

def mlp(x: torch.Tensor, p: dict, act: str) -> torch.Tensor:
    """Dense MLP. Param names: swiglu/geglu -> w_gate,w_up,w_down;
    relu2/gelu -> w_in,w_out."""
    if act in ("swiglu", "geglu"):
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        h = (F.silu(g) if act == "swiglu" else F.gelu(g, approximate="tanh")) * u
        return h @ p["w_down"]
    h = x @ p["w_in"]
    if act == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["w_out"]


# the dim of each MLP weight that the "fsdp" rule shards (d_model's)
_FSDP_DIM = {"w_gate": 0, "w_up": 0, "w_in": 0, "w_down": 1, "w_out": 1}


def _cols_over_model(p: dict, d_ff: int) -> bool:
    """Whether this rank's MLP params hold a share of the hidden columns
    (`d_ff` whole), i.e. are over "model"."""
    return (p["w_gate"] if "w_gate" in p else p["w_in"]).shape[-1] < d_ff


def sharded_mlp(x: torch.Tensor, p: dict, act: str, d_ff: int,
                mctx: Optional[MeshCtx], reduce: bool = True) -> torch.Tensor:
    """`mlp` on one layer's local MLP params, cast to x's dtype: the fsdp
    dim gathered over "data" where it is sharded; where the hidden
    columns (`d_ff` whole) are over "model", column-parallel in and
    row-parallel out, the partial outputs summed over "model" (with
    `reduce` False, left to `mlp_sum`)."""
    cdt = x.dtype
    w = {k: gather_fsdp(v, _FSDP_DIM[k], mctx, x.shape[-1]).to(cdt)
         for k, v in p.items()}
    if _cols_over_model(p, d_ff):
        y = mlp(copy_to_model(x, mctx), w, act)
        return reduce_from_model(y, mctx) if reduce else y
    return mlp(x, w, act)


def mlp_sum(y: torch.Tensor, p: dict, d_ff: int,
            mctx: Optional[MeshCtx]) -> torch.Tensor:
    """`sharded_mlp`'s output from what it returns with `reduce` False:
    summed over "model" where p's hidden columns are over it."""
    return reduce_from_model(y, mctx) if _cols_over_model(p, d_ff) else y


# ---------------------------------------------------------------------------
# Loss

class _VocabParallelNLL(torch.autograd.Function):
    """-log softmax(logits)[label] from each "model" rank's block of the
    vocab: the max, the sum of exps and the label's logit all-reduced over
    `group`; the backward is softmax minus one-hot on the block."""

    @staticmethod
    def forward(ctx, logits, labels, group):
        lf = logits.float()
        vl = lf.shape[-1]
        m = lf.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        e = torch.exp(lf - m[..., None])
        s = e.sum(dim=-1)
        dist.all_reduce(s, group=group)
        t = labels.long() - dist.get_rank(group) * vl
        inside = (t >= 0) & (t < vl)
        t = torch.where(inside, t, 0)
        ll = torch.where(inside, torch.gather(lf, -1, t[..., None])[..., 0],
                         0.0)
        dist.all_reduce(ll, group=group)
        ctx.save_for_backward(e, s, t, inside)
        ctx.dtype = logits.dtype
        return torch.log(s) + m - ll

    @staticmethod
    def backward(ctx, g):
        e, s, t, inside = ctx.saved_tensors
        d = e / s[..., None]
        d.scatter_add_(-1, t[..., None], -inside[..., None].to(d.dtype))
        return (d * g[..., None]).to(ctx.dtype), None, None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 mctx: Optional[MeshCtx] = None) -> torch.Tensor:
    """Stable mean cross-entropy. logits (..., V) any dtype; reduce in f32.
    With `mctx`, logits are this rank's block of the vocab along "model"
    (vocab-parallel; the reference keeps its logits sharded there) and the
    loss is the whole vocab's, the same on every model rank."""
    if mctx is None:
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    else:
        nll = _VocabParallelNLL.apply(logits, labels, mctx.group("model"))
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)


# ---------------------------------------------------------------------------
# KV cache helpers

def last_positions(x: torch.Tensor, n: int) -> torch.Tensor:
    """x[:, -n:] of a (B, T, ...) tensor, a copy where x holds more
    positions: a view would keep the whole sequence's storage alive for as
    long as the state holding it (a prefill keeps every layer's state
    until it stacks them)."""
    tail = x[:, -n:]
    return tail.clone() if x.shape[1] > n else tail


def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, pos: int):
    """Write k,v (B, t, KH, D) into copies of the caches at position pos
    (clamped so the slice fits, as lax.dynamic_update_slice does)."""
    t = k.shape[1]
    pos = max(0, min(int(pos), cache_k.shape[1] - t))
    ck, cv = cache_k.clone(), cache_v.clone()
    ck[:, pos:pos + t] = k.to(ck.dtype)
    cv[:, pos:pos + t] = v.to(cv.dtype)
    return ck, cv
