"""The port's flash-attention backward against the reference on the CPU.

On a CPU tensor the port's backward is its plain PyTorch version
(`ref.flash_attention_bwd_ref`); the reference's runs its Pallas backward
kernels in interpret mode, as tests/test_kernels.py runs them. Inputs are
made from a seed with numpy and handed to both. Tolerances are the
reference's own for its backward kernel (tests/test_kernels.py:303): 2e-4
in float32, 5e-2 in bfloat16.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_attention.kernel_bwd import (
    flash_attention_bwd as jbwd)
from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import flash_attention_bwd_ref

# B, T, H, KH, D, window, dtype: the reference's backward cases
# (tests/test_kernels.py:275-283) and head_dim 256
CASES = [
    (1, 128, 4, 2, 64, None, "float32"),     # GQA group reduction
    (2, 64, 4, 1, 64, None, "float32"),      # MQA
    (1, 128, 2, 2, 64, 32, "float32"),       # local window
    (1, 100, 2, 2, 64, None, "float32"),     # non-multiple T
    (1, 128, 2, 2, 128, None, "bfloat16"),   # bf16, head_dim 128
    (1, 64, 4, 2, 256, None, "float32"),     # head_dim 256
]
NP = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}
TOL = {"float32": 2e-4, "bfloat16": 5e-2}
BLOCK = 64


def _inputs(seed, B, T, H, KH, D, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32).astype(NP[dtype])
            for shape in ((B, T, H, D), (B, T, KH, D), (B, T, KH, D),
                          (B, T, H, D))]


def _torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _pad(x: np.ndarray, axis: int, n: int) -> np.ndarray:
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, n - x.shape[axis])
    return np.pad(x, widths)


@pytest.mark.parametrize("B,T,H,KH,D,window,dtype", CASES)
def test_bwd_ref_matches_reference_kernel(B, T, H, KH, D, window, dtype):
    """flash_attention_bwd_ref against the reference's Pallas dq and dkv
    kernels (interpret) on the same padded inputs; the reference's per-head
    dk and dv summed over each GQA group, as its ops wrapper sums them."""
    q, k, v, dout = _inputs(T * 3 + D + H, B, T, H, KH, D, dtype)
    tp = -(-T // BLOCK) * BLOCK
    qp, kp, vp, dop = (_pad(x, 1, tp) for x in (q, k, v, dout))
    scale = 1.0 / np.sqrt(D)
    out, lse = jref(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp),
                    scale=scale, causal=True, window=window, seq_k=T,
                    return_lse=True)
    out, lse = np.asarray(out), np.asarray(lse)
    dq, dk, dv = jbwd(jnp.asarray(qp), jnp.asarray(kp), jnp.asarray(vp),
                      jnp.asarray(out), jnp.asarray(lse), jnp.asarray(dop),
                      scale=scale, causal=True, window=window, seq_k=T,
                      block_q=BLOCK, block_k=BLOCK, interpret=True)
    G = H // KH
    want = (_f32(dq), _f32(dk).reshape(B, tp, KH, G, D).sum(3),
            _f32(dv).reshape(B, tp, KH, G, D).sum(3))
    got = flash_attention_bwd_ref(*(_torch(x) for x in (qp, kp, vp, out)),
                                  _torch(lse), _torch(dop),
                                  scale=scale, causal=True, window=window,
                                  seq_k=T)
    assert tuple(got[0].shape) == (B, tp, H, D)
    assert all(tuple(g.shape) == (B, tp, KH, D) for g in got[1:])
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_f32(g)[:, :T], w[:, :T], atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=name)


@pytest.mark.parametrize("B,T,H,KH,D,window,dtype", CASES)
def test_flash_grads_match_reference_vjp(B, T, H, KH, D, window, dtype):
    """Autograd through the port's flash_attention (its backward's plain
    version on the CPU) against jax.vjp of the reference's flash_attention
    (its Pallas forward and backward kernels, interpreted)."""
    q, k, v, dout = _inputs(T + D * 5 + KH, B, T, H, KH, D, dtype)
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, window=window,
                                            block_q=BLOCK, block_k=BLOCK),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    qkv = [_torch(x).requires_grad_() for x in (q, k, v)]
    before = ops.launches()
    out = ops.flash_attention(*qkv, window=window, block_q=BLOCK,
                              block_k=BLOCK)
    got = torch.autograd.grad(out, qkv, _torch(dout))
    assert ops.launches() == before       # no kernel on the CPU
    for g, w, x, name in zip(got, want, qkv, ("dq", "dk", "dv")):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_allclose(_f32(g), _f32(w), atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=name)


def test_softcap_grads_take_the_plain_autograd_and_are_counted():
    """Softcap keeps the reference's split: the backward is autograd
    through the plain attention, counted under bwd_softcap; the grads
    equal jax.vjp of the reference's flash_attention, whose softcap
    backward is a jnp vjp too."""
    q, k, v, dout = _inputs(11, 1, 96, 4, 2, 64, "float32")
    _, vjp = jax.vjp(lambda a, b, c: jflash(a, b, c, softcap=20.0,
                                            block_q=BLOCK, block_k=BLOCK),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(dout))
    qkv = [_torch(x).requires_grad_() for x in (q, k, v)]
    before = ops.launches()["bwd_softcap"]
    out = ops.flash_attention(*qkv, softcap=20.0, block_q=BLOCK,
                              block_k=BLOCK)
    got = torch.autograd.grad(out, qkv, _torch(dout))
    assert ops.launches()["bwd_softcap"] == before + 1
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(_f32(g), _f32(w), atol=2e-4, rtol=2e-4,
                                   err_msg=name)


def test_no_grad_forward_builds_no_graph():
    """Without grad (serving, inference_mode) the forward is called
    directly: the output carries no backward node."""
    q, k, v, _ = _inputs(3, 1, 32, 2, 2, 64, "float32")
    qkv = [_torch(x).requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out = ops.flash_attention(*qkv)
    assert out.grad_fn is None and not out.requires_grad
    out = ops.flash_attention(*qkv)
    assert out.grad_fn is not None
