"""The bf16 rounding points of the tensor-core flash kernels, on the CPU.

The port's bf16 flash kernels (`csrc/flash_attention_fwd.cu`,
`csrc/flash_attention_bwd.cu`) feed bf16 operands to the tensor cores and
accumulate in float32. Besides the inputs, they round only p, where the
forward feeds it to p.v as two bf16 parts, bf16(p) and bf16(p - bf16(p))
(its row sum l is taken from the float32 p before that), and in the
backward p and ds, where they feed dv = p^T.dout and dq = ds.k,
dk = ds^T.q; lse, delta, the exponent and the masks stay float32.
`_fwd_rounded` and `_bwd_rounded` below are plain float32 computations
with exactly those rounding points (the forward walks the kv tiles of 64
as the kernel does, so p is split at the running max). On bf16 inputs
made from a numpy seed they are held against the reference's
`flash_attention` forward and its VJP (its Pallas kernels in interpret
mode, as tests/test_kernels.py runs them) at the reference's bf16
tolerances: 2e-2 forward, 5e-2 backward (tests/test_kernels.py:56, :303).
So the rounding the design adds fits those tolerances before any run on
the card.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref

MASK_VALUE = -1e30
BLOCK = 64          # the reference's kernel tiles
KV_TILE = 64        # the port's forward kv tile
FWD_TOL, BWD_TOL = 2e-2, 5e-2

# B, T, H, KH, D, window
CASES = [
    (1, 256, 4, 1, 64, None),     # causal
    (1, 256, 4, 1, 64, 64),       # local window
    (1, 200, 4, 1, 256, None),    # head_dim 256, ragged T
]


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 (to nearest even) and back to float32."""
    return x.to(torch.bfloat16).float()


def _scores(q, k, scale, window):
    """float32 masked scores (B, KH, G, T, S) of bf16-valued q, k."""
    B, T, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    s = torch.einsum("btkgd,bskd->bkgts", q.reshape(B, T, KH, H // KH, D),
                     k) * scale
    qpos = torch.arange(T)[:, None]
    kpos = torch.arange(S)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return torch.where(mask, s, torch.tensor(MASK_VALUE))


def _fwd_rounded(q, k, v, scale, window):
    """out (B,T,H,D), lse (B,H,T): online softmax over kv tiles, l summed
    from the float32 p, p split into two bf16 parts as the A operands of
    p.v."""
    B, T, H, D = q.shape
    S = k.shape[1]
    s = _scores(q, k, scale, window)
    m = torch.full(s.shape[:-1], MASK_VALUE)
    l = torch.zeros(s.shape[:-1])
    o = torch.zeros(*s.shape[:-1], D)
    for k0 in range(0, S, KV_TILE):
        st = s[..., k0:k0 + KV_TILE]
        mn = torch.maximum(m, st.amax(-1))
        corr = torch.exp(m - mn)
        p = torch.exp(st - mn[..., None])
        l = l * corr + p.sum(-1)
        hi = _bf16(p)
        o = o * corr[..., None] + torch.einsum(
            "bkgts,bskd->bkgtd", hi + _bf16(p - hi), v[:, k0:k0 + KV_TILE])
        m = mn
    l = l.clamp_min(1e-30)
    out = (o / l[..., None]).permute(0, 3, 1, 2, 4).reshape(B, T, H, D)
    return _bf16(out), (m + torch.log(l)).reshape(B, H, T)


def _bwd_rounded(q, k, v, out, lse, dout, scale, window):
    """dq (B,T,H,D), dk, dv (B,S,KH,D) summed over each group, with p and
    ds rounded to bf16 where they feed a product."""
    B, T, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    s = _scores(q, k, scale, window)
    p = torch.exp(s - lse.reshape(B, KH, G, T)[..., None])
    dof = dout.reshape(B, T, KH, G, D)
    dp = torch.einsum("btkgd,bskd->bkgts", dof, v)
    delta = (dout * out).sum(-1).reshape(B, T, KH, G).permute(0, 2, 3, 1)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bkgts,bskd->btkgd", _bf16(ds), k).reshape(B, T, H, D)
    dk = torch.einsum("bkgts,btkgd->bskd", _bf16(ds),
                      q.reshape(B, T, KH, G, D))
    dv = torch.einsum("bkgts,btkgd->bskd", _bf16(p), dof)
    return dq, dk, dv


def _inputs(seed, B, T, H, KH, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32).astype(ml_dtypes.bfloat16)
            for shape in ((B, T, H, D), (B, T, KH, D), (B, T, KH, D),
                          (B, T, H, D))]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("B,T,H,KH,D,window", CASES)
def test_forward_rounding_fits_reference_tolerance(B, T, H, KH, D, window):
    """out and lse with p split into two bf16 parts before p.v, against
    the reference's flash_attention (Pallas, interpreted) and its lse."""
    q, k, v, _ = _inputs(T + D, B, T, H, KH, D)
    scale = 1.0 / np.sqrt(D)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  window=window, block_q=BLOCK, block_k=BLOCK)
    _, want_lse = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       scale=scale, causal=True, window=window,
                       return_lse=True)
    out, lse = _fwd_rounded(_t(q), _t(k), _t(v), scale, window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want, np.float32),
                               atol=FWD_TOL, rtol=FWD_TOL, err_msg="out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse, np.float32),
                               atol=FWD_TOL, rtol=FWD_TOL, err_msg="lse")


@pytest.mark.parametrize("B,T,H,KH,D,window", CASES)
def test_backward_rounding_fits_reference_tolerance(B, T, H, KH, D, window):
    """dq, dk and dv with p and ds rounded to bf16 where they feed a
    product, against jax.vjp of the reference's flash_attention (its
    Pallas forward and backward kernels, interpreted)."""
    q, k, v, dout = _inputs(T * 3 + D, B, T, H, KH, D)
    scale = 1.0 / np.sqrt(D)
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, window=window,
                                            block_q=BLOCK, block_k=BLOCK),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    qt, kt, vt, dot = (_t(x) for x in (q, k, v, dout))
    out, lse = _fwd_rounded(qt, kt, vt, scale, window)
    got = _bwd_rounded(qt, kt, vt, out, lse, dot, scale, window)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_bf16(g).numpy(), np.asarray(w, np.float32),
                                   atol=BWD_TOL, rtol=BWD_TOL, err_msg=name)
