"""The arithmetic of the tensor-core WKV kernel, on the CPU.

The port's `wkv6` kernel (`csrc/wkv6.cu`) splits the chunked WKV into two
passes over chunks of 32 steps and runs its four products on the tensor
cores in 3xTF32. `_wkv_tc` below is a plain float32 computation of exactly
that decomposition, with lw = log(clip(w, 1e-12, 1)), cum its inclusive
cumulative sum over a chunk, cum_prev its exclusive one (cum of the row
before, 0 at the first row) and tot = cum at the chunk's last row:

  state pass  S_0 = s0; S_{c+1} = diag(exp(tot)) S_c + kt^T . v, with
              kt = k * exp(tot - cum); every S_c is kept (the workspace);
  out pass    y = (r * exp(cum_prev)) . S_c + att . v, where att is built
              by blocks: the four diagonal 8 x 8 blocks pairwise, sum_i
              r_t,i k_s,i exp(cum_prev_t,i - cum_s,i) for s < t and the
              bonus sum_i r_t,i u_i k_t,i for s = t; and below them three
              blocks as products rh . kh^T, each factored at its boundary
              ref = cum at the row before its first row, rh = r *
              exp(cum_prev - ref), kh = k * exp(ref - cum), both exponents
              <= 0: the 16 x 16 block t in 16..31, s in 0..15 (ref = cum at
              row 15), and the 8 x 8 blocks t in 8..15, s in 0..7 (row 7)
              and t in 24..31, s in 16..23 (row 23).

A ragged last chunk is padded with w = 1 and r = k = v = 0. Every product
(rh . kh^T, (r * exp(cum_prev)) . S_c, att . v and kt^T . v) is taken in
3xTF32: each operand x is split into hi = tf32(x), rounded to nearest
with ties away from zero to 10 mantissa bits (the kernel's
cvt.rna.tf32.f32), and lo = x - hi, which the kernel hands to the mma as
float32 bits and the tensor core reads truncated to 10 bits; a.b = lo.hi
+ hi.lo + hi.hi in float32. The kernel takes logs and exponentials in
base 2 (log2 of w, exp2 of the log2 cumulative sums), as here; their
MUFU approximations (ex2.approx, and lg2.approx in the out pass, about
2^-22 each) are left out.
On inputs made from a numpy seed it is held against the reference's `wkv6`
(its Pallas kernel in interpret mode, as tests/test_kernels.py runs it)
and its sequential `wkv_ref` at the reference's tolerances: 3e-4, and 1e-4
under strong decay (tests/test_kernels.py:166, :203). A witness pins why
the kernel splits: with each operand rounded once to TF32 the same
decomposition falls outside 3e-4.

cum_prev is taken from the row before and not as cum - lw (the
reference's form, `ref.wkv_chunked_ref`): then the exponent of an adjacent
pair, cum_prev_t - cum_t-1, and of the boundary factors are exactly 0.
Under strong decay |cum| grows by 27.6 a step, and cum - lw leaves an
exponent error of an ulp of cum (about 6e-5 at row 31) on terms that do
not decay: on (1, 200, 2, 64) with half the channels at w = 1e-12 that
form misses 1e-4 (1.6e-3 at |y| = 37), where this one holds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.rwkv6_scan.ops import wkv6 as ref_wkv6
from repro.kernels.rwkv6_scan.ref import wkv_ref as ref_wkv_ref

CHUNK, PAIR = 32, 8         # the kernel's chunk and pairwise att blocks
# att's factored blocks: rows r0.., columns c0.., width; ref = cum at row
# r0 - 1, the last row of the column block
FACTORED = [(16, 0, 16), (8, 0, 8), (24, 16, 8)]
TOL, STRONG_TOL = 3e-4, 1e-4


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x: torch.Tensor) -> torch.Tensor:
    """x's float32 bits as the tensor core reads a TF32 operand: the low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: lo.hi + hi.lo + hi.hi, accumulated in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each operand rounded once to TF32."""
    return _tf32(a) @ _tf32(b)


def _wkv_tc(r, k, v, w, u, s0=None, mm=_mm3):
    """(y (B,T,H,hd), final state (B,H,hd,hd)) by the kernel's two passes,
    every product through `mm`."""
    B, T, H, hd = r.shape
    n = -(-T // CHUNK)
    pad = n * CHUNK - T

    def chunks(x, fill):            # (B, H, n, C, hd)
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad), value=fill)
        return x.reshape(B, n, CHUNK, H, hd).permute(0, 3, 1, 2, 4)

    rc, kc, vc = chunks(r, 0.0), chunks(k, 0.0), chunks(v, 0.0)
    lw = torch.log2(torch.clamp(chunks(w, 1.0), 1e-12, 1.0))
    cum = torch.cumsum(lw, dim=3)
    cp = torch.nn.functional.pad(cum[..., :-1, :], (0, 0, 1, 0))
    tot = cum[..., -1, :]                                  # (B, H, n, hd)

    # state pass: S_c entering every chunk, and the final state
    S = (torch.zeros(B, H, hd, hd) if s0 is None else s0.clone())
    states = []
    for c in range(n):
        states.append(S)
        kt = kc[:, :, c] * torch.exp2(tot[:, :, c, None] - cum[:, :, c])
        S = (torch.exp2(tot[:, :, c])[..., None] * S
             + mm(kt.transpose(-1, -2), vc[:, :, c]))
    Sc = torch.stack(states, dim=2)                        # (B, H, n, hd, hd)

    # out pass: every chunk on its own
    y = mm(rc * torch.exp2(cp), Sc)
    att = torch.zeros(B, H, n, CHUNK, CHUNK)
    lower = torch.tril(torch.ones(PAIR, PAIR, dtype=torch.bool), -1)
    for b0 in range(0, CHUNK, PAIR):                       # diagonal blocks
        blk = slice(b0, b0 + PAIR)
        e = cp[..., blk, None, :] - cum[..., None, blk, :]
        pair = (rc[..., blk, None, :] * kc[..., None, blk, :]
                * torch.exp2(e)).sum(-1)
        bonus = (rc[..., blk, :] * u[None, :, None, None, :]
                 * kc[..., blk, :]).sum(-1)
        att[..., blk, blk] = (torch.where(lower, pair, 0.0)
                              + torch.diag_embed(bonus))
    for r0, c0, width in FACTORED:
        ref = cum[..., r0 - 1:r0, :]
        rows, cols = slice(r0, r0 + width), slice(c0, c0 + width)
        rh = rc[..., rows, :] * torch.exp2(cp[..., rows, :] - ref)
        kh = kc[..., cols, :] * torch.exp2(ref - cum[..., cols, :])
        att[..., rows, cols] = mm(rh, kh.transpose(-1, -2))
    y = y + mm(att, vc)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, n * CHUNK, H, hd)[:, :T]
    return y, S


def _inputs(seed, B, T, H, hd):
    """tests/test_torch_wkv6.py's recipe: decays mostly near 1 with some
    strong-decay channels."""
    rng = np.random.default_rng(seed)
    r = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = (0.5 * rng.standard_normal((B, T, H, hd))).astype(np.float32)
    v = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    w = np.exp(-np.exp(rng.standard_normal((B, T, H, hd)))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, hd))).astype(np.float32)
    s0 = (0.1 * rng.standard_normal((B, H, hd, hd))).astype(np.float32)
    return r, k, v, w, u, s0


def _strong_inputs(seed, B, T, H, hd):
    """Half the channels at w = 1e-12, half near 1."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = np.where(np.arange(hd) < hd // 2, np.float32(1e-12),
                 rng.uniform(0.9, 1.0, (B, T, H, hd))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, hd))).astype(np.float32)
    return r, k, v, w, u


def _t(xs):
    return [torch.from_numpy(x) for x in xs]


def _j(xs):
    return [jnp.asarray(x) for x in xs]


# B, T, H, hd, the reference kernel's chunk: the reference's four
# (tests/test_kernels.py:153-154), a prime T at head_dim 16, a ragged T at
# head_dim 128 and T = 1
CASES = [(1, 64, 2, 32, 16), (2, 96, 2, 64, 32), (1, 33, 1, 64, 16),
         (1, 128, 4, 64, 64), (1, 37, 3, 16, 32), (1, 70, 2, 128, 32),
         (2, 1, 2, 64, 32)]


@pytest.mark.parametrize("with_s0", [False, True])
@pytest.mark.parametrize("B,T,H,hd,chunk", CASES)
def test_3xtf32_decomposition_fits_reference_tolerance(B, T, H, hd, chunk,
                                                       with_s0):
    xs = list(_inputs(T + hd, B, T, H, hd))
    if not with_s0:
        xs = xs[:5]
    y, s = _wkv_tc(*_t(xs))
    ky, ks = ref_wkv6(*_j(xs), chunk=chunk)
    ry, rs = ref_wkv_ref(*_j(xs))
    for got, want, what in ((y, ky, "y/kernel"), (s, ks, "state/kernel"),
                            (y, ry, "y/sequential"),
                            (s, rs, "state/sequential")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL, err_msg=what)


@pytest.mark.parametrize("B,T,H,hd,strong", [
    (1, 64, 1, 32, "all"),          # tests/test_kernels.py:190-203
    (1, 200, 2, 64, "half")])       # seven chunks, the factoring's underflow
def test_3xtf32_decomposition_under_strong_decay(B, T, H, hd, strong):
    if strong == "all":
        rng = np.random.default_rng(31)
        r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32)
                   for _ in range(3))
        xs = [r, k, v, np.full((B, T, H, hd), 1e-9, np.float32),
              np.zeros((H, hd), np.float32)]
    else:
        xs = list(_strong_inputs(7, B, T, H, hd))
    y, s = _wkv_tc(*_t(xs))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ry, rs = ref_wkv_ref(*_j(xs))
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=STRONG_TOL,
                               rtol=STRONG_TOL, err_msg="y")
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=STRONG_TOL,
                               rtol=STRONG_TOL, err_msg="state")


def test_single_tf32_rounding_falls_outside_tolerance():
    """The witness: the same decomposition with each operand rounded once
    to TF32 misses 3e-4 on the reference's (2, 96, 2, 64), where 3xTF32
    holds (above)."""
    xs = _inputs(96 + 64, 2, 96, 2, 64)
    y, s = _wkv_tc(*_t(xs), mm=_mm1)
    ry, rs = ref_wkv_ref(*_j(xs))
    err = max(float(np.abs(y.numpy() - np.asarray(ry)).max()),
              float(np.abs(s.numpy() - np.asarray(rs)).max()))
    assert err > 10 * TOL, err
