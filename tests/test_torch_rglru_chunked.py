"""The arithmetic of the `rglru_scan` kernel (`csrc/rglru_scan.cu`), on the
CPU, against the reference.

The kernel splits T across the warps of a CTA: T is walked in windows of
warps x SEG steps; in a window each warp scans its SEG steps from zero to
(A = prod a, H = local h), takes its carry-in by folding the window's
carry with the (A, H) of the warps before it, then runs the recurrence
over its steps again from that carry and writes h; the last warp's final
h carries into the next window. The kernel runs only on the card, so
`_kernel_emulation` below does the same float32 operations in that order
(each fmaf as one rounding of the exact float64 value) and is held at
1e-5, the reference's tolerance (tests/test_kernels.py:103-117), against
the reference's `rglru_scan` (its Pallas kernel in interpret mode, as
tests/test_kernels.py runs it on the CPU) and its `rglru_scan_ref`:
forward and reverse, with and without h0, T at the window's edges, R not
a multiple of the CTA's 32 channels, and decays near 1 over 4096 steps.
tests/test_torch_cuda.py holds the kernel itself against the plain
version on the card.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.rglru_scan.ops import rglru_scan as ref_rglru_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as ref_scan_ref
from repro_torch.kernels.rglru_scan import kernel as K

TOL = dict(atol=1e-5, rtol=1e-5)
WINDOW = K.WINDOW


def _fma(a, x, b):
    """fmaf: a * x + b rounded once to float32 (a float32 product is exact
    in float64)."""
    return (a.double() * x.double() + b.double()).float()


def _warps(T: int) -> int:
    """The launch's warps along T: the fewest whose segments cover T, a
    power of two, up to K.WARPS."""
    warps = 1
    while warps < K.WARPS and warps * K.SEG < T:
        warps *= 2
    return warps


def _kernel_emulation(a, b, h0=None, reverse=False):
    """h of the kernel, float32, in the kernel's order of operations."""
    a, b = a.float(), b.float()
    if reverse:
        a, b = a.flip(1), b.flip(1)
    B, T, R = a.shape
    warps = _warps(T)
    window = warps * K.SEG
    n_win = -(-T // window)
    pad = n_win * window - T
    a = torch.cat([a, torch.ones(B, pad, R)], 1)       # identity steps
    b = torch.cat([b, torch.zeros(B, pad, R)], 1)
    a = a.view(B, n_win, warps, K.SEG, R)
    b = b.view(B, n_win, warps, K.SEG, R)
    carry = torch.zeros(B, R) if h0 is None else h0.float()
    out = []
    for w in range(n_win):
        av, bv = a[:, w], b[:, w]                       # (B, warps, SEG, R)
        A, H = torch.ones(B, warps, R), torch.zeros(B, warps, R)
        for u in range(K.SEG):                          # chunk-local scan
            H = _fma(av[:, :, u], H, bv[:, :, u])
            A = A * av[:, :, u]
        x, carry_in = carry, []
        for k in range(warps):                          # carry combine
            carry_in.append(x)
            x = _fma(A[:, k], x, H[:, k])
        x, hs = torch.stack(carry_in, 1), []
        for u in range(K.SEG):                          # fix-up
            x = _fma(av[:, :, u], x, bv[:, :, u])
            hs.append(x)
        out.append(torch.stack(hs, 2))                  # (B, warps, SEG, R)
        carry = x[:, -1]
    h = torch.stack(out, 1).reshape(B, n_win * window, R)[:, :T]
    return h.flip(1) if reverse else h


def _inputs(seed, B, T, R, near_one=False):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((B, T, R))
    if near_one:
        # carries travel far: a in (0.999, 1), and b scaled by sqrt(1 - a^2)
        # as the model feeds the scan (repro/models/recurrent.py:127), so h
        # stays O(1). Unscaled, |h| reaches ~110 over 4096 steps and every
        # float32 order, the reference's own kernel and oracle included, is
        # 3.5-4.6x the 1e-5 tolerance away from the float64 recurrence.
        a = 1.0 - 1e-3 * rng.random((B, T, R))
        b = b * np.sqrt(1.0 - a * a)
    else:          # decays in (0,1) like the model's exp(log_a)
        a = 1.0 / (1.0 + np.exp(-2.0 * rng.standard_normal((B, T, R))))
    h0 = rng.standard_normal((B, R))
    return a.astype(np.float32), b.astype(np.float32), h0.astype(np.float32)


def _reference(a, b, h0, reverse, pallas=True):
    """The reference's scan (interpret-mode Pallas kernel, or its
    associative-scan oracle), time-reversed for the reverse mode."""
    if reverse:
        a, b = a[:, ::-1].copy(), b[:, ::-1].copy()
    h0 = None if h0 is None else jnp.asarray(h0)
    if pallas:
        h = ref_rglru_scan(jnp.asarray(a), jnp.asarray(b), h0, block_t=32,
                           block_r=64)
    else:
        h = ref_scan_ref(jnp.asarray(a), jnp.asarray(b), h0)
    h = np.asarray(h)
    return h[:, ::-1] if reverse else h


def test_chunk_sizes_are_the_kernels():
    """The emulation's SEG and WARPS are the source's RGLRU_SEG and
    RGLRU_WARPS."""
    src = (Path(K.__file__).resolve().parents[2] / "csrc"
           / "rglru_scan.cu").read_text()
    for name, value in (("RGLRU_SEG", K.SEG), ("RGLRU_WARPS", K.WARPS)):
        assert int(re.search(rf"#define {name} (\d+)", src).group(1)) == value
    assert WINDOW == 64


@pytest.mark.parametrize("T", [1, WINDOW - 1, WINDOW, WINDOW + 1,
                               3 * WINDOW + 5, K.SEG - 1, K.SEG + 1])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("with_h0", [False, True])
def test_chunked_scan_matches_reference(T, reverse, with_h0):
    B, R = 2, 70                     # R: two CTAs of 32 channels and 6 more
    a, b, h0 = _inputs(T * 10 + reverse, B, T, R)
    h0 = h0 if with_h0 else None
    got = _kernel_emulation(torch.from_numpy(a), torch.from_numpy(b),
                            None if h0 is None else torch.from_numpy(h0),
                            reverse=reverse).numpy()
    np.testing.assert_allclose(got, _reference(a, b, h0, reverse), **TOL)
    np.testing.assert_allclose(got, _reference(a, b, h0, reverse,
                                               pallas=False), **TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_decays_near_one_over_4096_steps(reverse):
    """a in (0.999, 1) over 4096 steps (64 windows): every carry crosses
    many windows before it decays."""
    B, T, R = 1, 4096, 40
    a, b, h0 = _inputs(4096 + reverse, B, T, R, near_one=True)
    got = _kernel_emulation(torch.from_numpy(a), torch.from_numpy(b),
                            torch.from_numpy(h0), reverse=reverse).numpy()
    np.testing.assert_allclose(got, _reference(a, b, h0, reverse), **TOL)
    np.testing.assert_allclose(got, _reference(a, b, h0, reverse,
                                               pallas=False), **TOL)
    # and against the exact recurrence, in float64
    steps = range(T - 1, -1, -1) if reverse else range(T)
    h, exact = h0.astype(np.float64), np.zeros((B, T, R))
    for t in steps:
        h = a[:, t] * h + b[:, t].astype(np.float64)
        exact[:, t] = h
    np.testing.assert_allclose(got, exact, **TOL)
    # h0's weight after 4096 steps is prod a > 0.1: the carry crossed
    # every window
    assert np.prod(a.astype(np.float64), axis=1).min() > 0.1


def test_prefill_shape_in_miniature():
    """The serve path's prefill: T = 1024 (16 windows of 8 warps), no h0;
    a few channels, one of them past a multiple of 32."""
    B, T, R = 2, 1024, 33
    a, b, _ = _inputs(1024, B, T, R)
    got = _kernel_emulation(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), _reference(a, b, None, False),
                               **TOL)
