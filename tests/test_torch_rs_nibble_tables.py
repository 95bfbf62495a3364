"""The arithmetic of the `rs_matmul` kernel (`csrc/rs_parity.cu`), on the
CPU, against the reference bit for bit.

The kernel takes each GF(2^8) coefficient c as two 16-entry tables,
lo[v] = c*v and hi[v] = c*(v << 4) (`kernel.nibble_tables`), and looks
four bytes up at a time with PTX `prmt`: selectors from the low 3 bits of
each nibble, the half of the table picked by a byte mask of its bit 3,
then the m output rows walked with the s split input words held. The
kernel runs only on the card, so `_kernel_emulation` below does the same
word operations in numpy, prmt's byte selection and sign replication
included, and is held against the reference's numpy oracle and its
Pallas kernel in interpret mode: for every (c, v) in 256 x 256, the
ec(4,2) and ec(8,3) encodes, every decode subset and the delta matrices.
tests/test_torch_cuda.py holds the kernel itself against the plain
version on the card.
"""
import itertools

import numpy as np
import pytest

from repro.kernels.rs_parity import ops as jops
from repro.kernels.rs_parity import ref as jref
from repro_torch.kernels.rs_parity import kernel as K
from repro_torch.kernels.rs_parity import ref


def _prmt(a, b, sel):
    """PTX prmt.b32 in its default mode, over u32 arrays: result byte n is
    byte (sel >> 4n) & 7 of {b, a}, or that byte's top bit replicated where
    (sel >> 4n) & 8 is set."""
    a, b, sel = (x.astype(np.uint32).ravel() for x in np.broadcast_arrays(
        np.asarray(a, np.uint32), np.asarray(b, np.uint32),
        np.asarray(sel, np.uint32)))
    src = np.stack([(a >> (8 * i)) & 0xFF for i in range(4)]
                   + [(b >> (8 * i)) & 0xFF for i in range(4)])
    cols = np.arange(a.size)
    out = np.zeros(a.size, np.uint32)
    for n in range(4):
        s = (sel >> (4 * n)) & 0xF
        byte = src[s & 7, cols]
        byte = np.where(s & 8, np.where(byte & 0x80, 0xFF, 0), byte)
        out |= byte.astype(np.uint32) << np.uint32(8 * n)
    return out


def _split(x):
    """The kernel's `split`: selectors and masks of a u32 word array."""
    lo3 = (x & 0x07070707) | ((x >> 4) & 0x70707070)
    hi3 = ((x >> 4) & 0x07070707) | ((x >> 8) & 0x70707070)
    return (_prmt(lo3, 0, 0x4420), _prmt(hi3, 0, 0x4420),
            _prmt((x << 4) & 0xFFFFFFFF, 0, 0xBA98), _prmt(x, 0, 0xBA98))


def _nib16(t0, t1, t2, t3, sel, mask):
    return (_prmt(t0, t1, sel) & ~mask) | (_prmt(t2, t3, sel) & mask)


def _kernel_emulation(mat: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """(m, s) u8 times (s, L) u8 as the kernel computes it: rows padded to
    whole words (the ragged path loads the tail as zeros and stores only
    L bytes), four bytes a word, the rows loop over the split words."""
    tab = K.nibble_tables(mat).astype(np.uint32)
    m, s = mat.shape
    L = cells.shape[1]
    pad = np.zeros((s, -(-L // 4) * 4), np.uint8)
    pad[:, :L] = cells
    words = pad.view("<u4").astype(np.uint32)                # (s, L/4)
    parts = [_split(words[i]) for i in range(s)]
    out = np.zeros((m, words.shape[1]), np.uint32)
    for j in range(m):
        for i in range(s):
            sel_lo, sel_hi, mask_lo, mask_hi = parts[i]
            t = tab[j, i]
            out[j] ^= (_nib16(t[0], t[1], t[2], t[3], sel_lo, mask_lo)
                       ^ _nib16(t[4], t[5], t[6], t[7], sel_hi, mask_hi))
    return out.astype("<u4").view(np.uint8)[:, :L]


def test_prmt_emulation_follows_the_ptx_rules():
    a, b = np.uint32(0x83828180), np.uint32(0x07060504)
    assert _prmt(a, b, 0x3210) == a and _prmt(a, b, 0x7654) == b
    assert _prmt(a, b, 0x4567) == 0x04050607
    assert _prmt(a, b, 0xBA98) == 0xFFFFFFFF      # every top bit of a set
    assert _prmt(a, b, 0xFEDC) == 0               # none of b's


def test_tables_are_products_of_each_nibble():
    rng = np.random.default_rng(0)
    mat = rng.integers(0, 256, (11, 11), np.uint8)
    tab = K.nibble_tables(mat)
    assert tab.shape == (11, 11, 8) and tab.dtype == np.dtype("<u4")
    entries = tab.view(np.uint8).reshape(11, 11, 32)
    for j, i in itertools.product(range(11), range(11)):
        c = int(mat[j, i])
        v = np.arange(16, dtype=np.uint8)
        np.testing.assert_array_equal(entries[j, i, :16],
                                      jref.gf_mul_vec(c, v))
        np.testing.assert_array_equal(entries[j, i, 16:],
                                      jref.gf_mul_vec(c, v << 4))


def test_every_product_of_two_bytes():
    """c * v for every (c, v) in 256 x 256 through the emulated lookup,
    16 coefficients a matrix (one column), held against the reference's
    numpy oracle and its Pallas kernel in interpret mode."""
    v = np.arange(256, dtype=np.uint8)[None]                  # (1, 256)
    want = np.array([[jref.gf_mul(c, x) for x in range(256)]
                     for c in range(256)], np.uint8)
    for c0 in range(0, 256, 16):
        mat = np.arange(c0, c0 + 16, dtype=np.uint8)[:, None]  # (16, 1)
        got = _kernel_emulation(mat, v)
        np.testing.assert_array_equal(got, want[c0:c0 + 16])
        np.testing.assert_array_equal(got, jref.gf_matmul_np(mat, v))
        np.testing.assert_array_equal(got, np.asarray(jops.gf_matmul(
            mat, v, interpret=True)))


def _cases():
    """The EC path's matrices: both encodes, every decode subset of
    ec(4,2) and ec(8,3), the delta matrices of ec(4,2)."""
    out = [("encode", 4, 2, ref.cauchy_matrix(4, 2)),
           ("encode", 8, 3, ref.cauchy_matrix(8, 3))]
    for k, p in ((4, 2), (8, 3)):
        for lost in itertools.chain.from_iterable(
                itertools.combinations(range(k + p), n)
                for n in range(1, p + 1)):
            present = [i for i in range(k + p) if i not in lost][:k]
            missing = [i for i in lost if i < k]
            if missing:
                out.append((f"decode {lost}", k, p,
                            ref.decode_matrix(k, p, present, missing)))
    for n in range(1, 5):
        for idx in itertools.combinations(range(4), n):
            out.append((f"delta {idx}", 4, 2, np.ascontiguousarray(
                ref.cauchy_matrix(4, 2)[:, list(idx)])))
    return out


def test_every_ec_matrix_through_the_emulated_kernel():
    """Each matrix of the EC path against the reference's oracle, at a
    width with a ragged word (L = 1027); the encodes and a decode and a
    delta also against the reference's Pallas kernel (one compile each)."""
    rng = np.random.default_rng(3)
    cases = _cases()
    # ec(4,2): 18 decode subsets that lose a data cell; ec(8,3): 224
    assert len(cases) == 2 + 18 + 224 + 15
    kernel_checked = set()
    for what, k, p, mat in cases:
        m, s = mat.shape
        x = rng.integers(0, 256, (s, 1027), np.uint8)
        got = _kernel_emulation(mat, x)
        np.testing.assert_array_equal(got, jref.gf_matmul_np(mat, x),
                                      err_msg=f"ec({k},{p}) {what}")
        kind = (what.split()[0], k, m, s)
        if kind not in kernel_checked and k == 4:
            kernel_checked.add(kind)
            np.testing.assert_array_equal(got, np.asarray(jops.gf_matmul(
                mat, x, interpret=True)), err_msg=f"ec({k},{p}) {what}")
    assert {kd[0] for kd in kernel_checked} == {"encode", "decode", "delta"}


@pytest.mark.parametrize("L", [1, 3, 4, 8, 12, 35])
def test_widths_and_the_largest_matrix(L):
    """Ragged and whole-word widths at m = s = 11 (121 coefficients, the
    most the kernel takes) and at ec(8,3)'s 3 x 8 encode."""
    rng = np.random.default_rng(L)
    for mat in (rng.integers(0, 256, (11, 11), np.uint8),
                ref.cauchy_matrix(8, 3)):
        x = rng.integers(0, 256, (mat.shape[1], L), np.uint8)
        np.testing.assert_array_equal(_kernel_emulation(mat, x),
                                      jref.gf_matmul_np(mat, x))
