"""The port's RWKV6 WKV on the CPU against the reference's.

The same seeded numpy inputs go through the reference's `wkv6` (its Pallas
kernel in interpret mode, as tests/test_kernels.py runs it), its
sequential `wkv_ref` and its model-side `wkv_chunked`, and through the
port's `wkv6`, which on a CPU tensor picks the chunk and pads as the
reference does and runs the plain chunked version. Tolerances are the
reference's (tests/test_kernels.py:152-203): 3e-4, and 1e-4 under strong
decay, where every value must stay finite.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.rwkv6_scan.ops import wkv6 as ref_wkv6
from repro.kernels.rwkv6_scan.ref import wkv_ref as ref_wkv_ref
from repro.models import rwkv as ref_rwkv
from repro_torch.kernels.rwkv6_scan import ops, ref
from repro_torch.models import rwkv

TOL = dict(atol=3e-4, rtol=3e-4)


def _inputs(seed, B, T, H, hd):
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, T, H, hd))).astype(np.float32)
    v = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    # realistic decays: mostly close to 1 with some strong-decay channels
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hd)))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, hd))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    return r, k, v, w, u, s0


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("B,T,H,hd,chunk", [
    (1, 64, 2, 32, 16), (2, 96, 2, 64, 32), (1, 33, 1, 64, 16),
    (1, 128, 4, 64, 64),
    (1, 37, 2, 16, 32)])                  # prime T: the padded branch
def test_wkv6_matches_reference(B, T, H, hd, chunk):
    xs = _inputs(T + hd, B, T, H, hd)
    before = ops.launches()
    y, s = ops.wkv6(*_t(xs), chunk=chunk)
    assert ops.launches() == before       # the CPU runs no kernel
    assert y.dtype == s.dtype == torch.float32
    ky, ks = ref_wkv6(*_j(xs), chunk=chunk)
    ry, rs = ref_wkv_ref(*_j(xs))
    for got, want in ((y, ky), (s, ks), (y, ry), (s, rs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wkv6_strong_decay_stays_finite():
    """w ~ 0 must not overflow the chunked form (1e-4)."""
    B, T, H, hd = 1, 64, 1, 32
    rng = np.random.default_rng(31)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.full((B, T, H, hd), 1e-9, np.float32)
    u = np.zeros((H, hd), np.float32)
    y, s = ops.wkv6(*_t((r, k, v, w, u)), chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr = ref_wkv_ref(*_j((r, k, v, w, u)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yr), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(s.numpy(), np.asarray(sr), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("with_s0", [False, True])
def test_model_forms_match_reference(with_s0):
    r, k, v, w, u, s0 = _inputs(29, 1, 64, 2, 32)
    s0 = s0 if with_s0 else None
    args = [r, k, v, w, u]
    extra_t = [] if s0 is None else [torch.from_numpy(s0)]
    extra_j = [] if s0 is None else [jnp.asarray(s0)]
    for got, want in (
            (rwkv.wkv_chunked(*_t(args), *extra_t, chunk=16),
             ref_rwkv.wkv_chunked(*_j(args), *extra_j, chunk=16)),
            (rwkv.wkv_sequential(*_t(args), *extra_t),
             ref_rwkv.wkv_sequential(*_j(args), *extra_j)),
            (ops.wkv6(*_t(args), *extra_t, chunk=16),
             ref_rwkv.wkv_chunked(*_j(args), *extra_j, chunk=16))):
        for g, wnt in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)
    s = np.array(ref_wkv_ref(*_j(args))[1]) if s0 is None else s0
    one = [x[:, 0] for x in (r, k, v, w)]
    got = rwkv.wkv_decode(*_t(one), torch.from_numpy(u), torch.from_numpy(s))
    want = ref_rwkv.wkv_decode(*_j(one), jnp.asarray(u), jnp.asarray(s))
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), **TOL)


def test_chunked_plain_version_refuses_a_chunk_that_does_not_divide_t():
    xs = _t(_inputs(3, 1, 10, 1, 16))
    with pytest.raises(ValueError):
        ref.wkv_chunked_ref(*xs, chunk=4)


@pytest.mark.parametrize("with_s0", [False, True])
def test_grads_match_reference_vjp(with_s0):
    xs = _inputs(41, 1, 40, 2, 16)
    rng = np.random.default_rng(42)
    dy = rng.standard_normal(xs[0].shape).astype(np.float32)
    ds = rng.standard_normal(xs[5].shape).astype(np.float32)
    xs = xs if with_s0 else xs[:5]

    def ref_loss(*a):
        y, s = ref_wkv6(*a, chunk=16)
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    want = jax.grad(ref_loss, argnums=tuple(range(len(xs))))(*_j(xs))
    ins = [x.requires_grad_() for x in _t(xs)]
    y, s = ops.wkv6(*ins, chunk=16)
    ((y * torch.from_numpy(dy)).sum()
     + (s * torch.from_numpy(ds)).sum()).backward()
    for x, w in zip(ins, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **TOL)


def test_grads_under_the_step_recorder():
    """The WKV backward under a Python dispatch mode: the dry-run's
    recorder (`roofline.collectives.count_step`) counting a real step.
    Its gradients equal those of the same step run bare, and the FLOP
    counter sees the backward op (torch.func's vjp inside the op failed
    under a mode: "Cannot access storage of TensorWrapper")."""
    from repro_torch.roofline.collectives import count_step
    xs = _inputs(43, 1, 24, 2, 16)

    def grads(*a):
        ins = [x.clone().requires_grad_() for x in a]
        y, s = ops.wkv6(*ins, chunk=16)
        return torch.autograd.grad(y.square().sum() + s.sum(), ins)

    bare = grads(*_t(xs))
    counted = count_step(grads, *_t(xs))
    for got, want in zip(counted.outputs, bare):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert counted.flops_by_op.get("repro_torch.wkv6_backward", 0) > 0, (
        counted.flops_by_op)
