"""The port's RG-LRU scan on the CPU against the reference's.

The same seeded numpy inputs go through the reference's `rglru_scan` (its
Pallas kernel in interpret mode, as tests/test_kernels.py runs it) and
its `rglru_scan_ref` (an associative scan), and through the port's
`rglru_scan`, which on a CPU tensor runs the plain doubling scan
`ref.rglru_scan_ref`. Values agree to 1e-5 and gradients of sum(sin(h))
to 1e-4, the reference's own tolerances (tests/test_kernels.py:103-141).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.rglru_scan.ops import rglru_scan as ref_rglru_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as ref_scan_ref
from repro_torch.kernels.rglru_scan import ops, ref

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


def _inputs(seed, B, T, R, with_h0=True):
    rng = np.random.default_rng(seed)
    # decays in (0,1) like the model's exp(log_a)
    a = (1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((B, T, R))))
         ).astype(np.float32)
    b = rng.standard_normal((B, T, R)).astype(np.float32)
    h0 = rng.standard_normal((B, R)).astype(np.float32) if with_h0 else None
    return a, b, h0


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("B,T,R", [(1, 64, 128), (2, 128, 256),
                                   (1, 100, 96), (3, 32, 512),
                                   (2, 1, 96), (4, 1, 130)])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_matches_reference(B, T, R, with_h0):
    a, b, h0 = _inputs(B * T + R, B, T, R, with_h0)
    before = ops.launches()
    got = ops.rglru_scan(_t(a), _t(b), _t(h0))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, T, R)
    kernel = ref_rglru_scan(_j(a), _j(b), _j(h0), block_t=32, block_r=64)
    plain = ref_scan_ref(_j(a), _j(b), _j(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(plain), **TOL)
    assert ops.launches() == before       # the CPU runs no kernel


def test_reverse_mode_is_the_time_reversed_scan():
    a, b, h0 = _inputs(7, 2, 50, 33)
    got = ref.rglru_scan_ref(_t(a), _t(b), _t(h0), reverse=True)
    want = ref_scan_ref(_j(a[:, ::-1].copy()), _j(b[:, ::-1].copy()),
                        _j(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, ::-1], **TOL)


@pytest.mark.parametrize("with_h0", [False, True])
def test_grads_match_reference_vjp(with_h0):
    B, T, R = 1, 32, 64
    a, b, h0 = _inputs(13, B, T, R, with_h0)

    def ref_loss(a_, b_, *h):
        return jnp.sum(jnp.sin(ref_rglru_scan(a_, b_, *h, block_t=16,
                                              block_r=32)))

    argnums = (0, 1, 2) if with_h0 else (0, 1)
    want = jax.grad(ref_loss, argnums=argnums)(
        *(_j(x) for x in (a, b, h0) if x is not None))
    ins = [_t(x).requires_grad_() for x in (a, b, h0) if x is not None]
    torch.sin(ops.rglru_scan(*ins)).sum().backward()
    for x, w in zip(ins, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), **GRAD_TOL)


def test_plain_model_scan_is_the_plain_version():
    from repro.models.recurrent import _lru_scan as ref_lru_scan
    from repro_torch.models.recurrent import _lru_scan
    a, b, h0 = _inputs(11, 2, 64, 128)
    np.testing.assert_allclose(
        _lru_scan(_t(a), _t(b), _t(h0)).numpy(),
        np.asarray(ref_lru_scan(_j(a), _j(b), _j(h0))), **TOL)
