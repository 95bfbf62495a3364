"""The port's GF(256) Reed-Solomon ops against the reference, bit for bit.

Inputs are made with numpy from a seed and handed to three versions: the
reference's `repro.kernels.rs_parity.ops` (its Pallas kernel in interpret
mode on the CPU, as the reference's own tests run it), the reference's
numpy oracle, and the port's `repro_torch.kernels.rs_parity.ops` on CPU
tensors (its plain PyTorch version). tests/test_torch_cuda.py holds the
port's hand-written kernel against the plain version on the card.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.kernels.rs_parity import ops as jops
from repro.kernels.rs_parity import ref as jref
from repro_torch.kernels.rs_parity import ops
from repro_torch.kernels.rs_parity import ref

GEOMETRIES = [(2, 1), (4, 2), (8, 3)]
WIDTHS = [1, 127, 1024, 4097]
# The reference's interpret-mode kernel compiles once per (m, s, padded
# width), for seconds at ec(8,3). Every case goes against the reference's
# numpy oracle; the cases that also go through the reference's ops share
# the width below, so each geometry compiles once or twice.
REF_OPS_WIDTH = 4097


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch versions run on small tensors, fastest on one
    thread; the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(k, n, seed):
    return np.random.default_rng(seed).integers(0, 256, (k, n), np.uint8)


def _np(t: torch.Tensor) -> np.ndarray:
    assert t.dtype == torch.uint8 and t.device.type == "cpu"
    return t.numpy()


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("k,p", GEOMETRIES)
def test_encode_matches_reference(k, p, n):
    cells = _cells(k, n, seed=k * 1000 + n)
    got = _np(ops.ec_encode(cells, p, device="cpu"))
    np.testing.assert_array_equal(got, jref.rs_encode_np(cells, p))
    if n == REF_OPS_WIDTH:
        np.testing.assert_array_equal(got,
                                      np.asarray(jops.ec_encode(cells, p)))
    # a tensor input runs where it lies, with the same answer
    np.testing.assert_array_equal(
        _np(ops.ec_encode(torch.from_numpy(cells), p)), got)


@pytest.mark.parametrize("k,p", GEOMETRIES)
def test_decode_every_lost_subset(k, p):
    """Every p-subset of the k+p cells lost: the port decodes the lost
    data cells from the first k survivors exactly as the reference (its
    ops for the subsets that lose p data cells, its oracle for all)."""
    n = REF_OPS_WIDTH
    cells = _cells(k, n, seed=k)
    stripe = np.concatenate([cells, jref.rs_encode_np(cells, p)])
    for lost in itertools.combinations(range(k + p), p):
        present = [i for i in range(k + p) if i not in lost][:k]
        missing = [i for i in lost if i < k]
        got = _np(ops.ec_decode(stripe[present], present, k, p, missing,
                                device="cpu"))
        np.testing.assert_array_equal(got, cells[missing])
        np.testing.assert_array_equal(got, jref.rs_decode_np(
            stripe[present], present, k, p, missing))
        if len(missing) == p:
            np.testing.assert_array_equal(got, np.asarray(jops.ec_decode(
                stripe[present], present, k, p, missing)))
        # default `missing`: every data cell not among the survivors
        np.testing.assert_array_equal(
            _np(ops.ec_decode(stripe[present], present, k, p,
                              device="cpu")), got)


@pytest.mark.parametrize("k,p", GEOMETRIES)
def test_parity_delta_over_touched_subsets(k, p):
    """Delta-parity RMW: for touched subsets of the data cells, the port's
    parity deltas equal the reference's, and XORed onto the old parity
    they give the full re-encode of the new stripe (GF linearity). Every
    touched subset against the reference's oracle; the one-cell and
    all-cell subsets through its ops too."""
    n = REF_OPS_WIDTH
    rng = np.random.default_rng(k + p)
    old = _cells(k, n, seed=99)
    subsets = [s for r in range(1, k + 1)
               for s in itertools.combinations(range(k), r)]
    for idx in subsets:
        idx = list(idx)
        new = old.copy()
        new[idx] = rng.integers(0, 256, (len(idx), n), np.uint8)
        deltas = old[idx] ^ new[idx]
        got = _np(ops.ec_parity_delta(k, p, idx, deltas, device="cpu"))
        np.testing.assert_array_equal(got, jref.rs_parity_delta_np(
            k, p, idx, deltas))
        if len(idx) in (1, k):
            np.testing.assert_array_equal(got, np.asarray(
                jops.ec_parity_delta(k, p, idx, deltas)))
        np.testing.assert_array_equal(
            jref.rs_encode_np(old, p) ^ got, jref.rs_encode_np(new, p))


@pytest.mark.parametrize("n", WIDTHS)
def test_plain_version_matches_numpy_oracle(n):
    """`gf_matmul_torch` (shift/xor on int32) equals the table-driven
    numpy oracle for arbitrary coefficient matrices up to 11 x 11."""
    rng = np.random.default_rng(n)
    for m, s in [(1, 1), (3, 5), (11, 11)]:
        mat = rng.integers(0, 256, (m, s), np.uint8)
        x = rng.integers(0, 256, (s, n), np.uint8)
        got = ref.gf_matmul_torch(mat, torch.from_numpy(x))
        np.testing.assert_array_equal(_np(got), jref.gf_matmul_np(mat, x))
        np.testing.assert_array_equal(
            _np(ops.gf_matmul(mat, x, device="cpu")), _np(got))


def test_numpy_oracle_is_the_reference_oracle():
    """The port keeps its own copy of the oracle; it must stay the
    reference's, table for table."""
    np.testing.assert_array_equal(ref.GF_EXP, jref.GF_EXP)
    np.testing.assert_array_equal(ref.GF_LOG, jref.GF_LOG)
    for k, p in GEOMETRIES:
        np.testing.assert_array_equal(ref.cauchy_matrix(k, p),
                                      jref.cauchy_matrix(k, p))


def test_checks_match_reference():
    cells = _cells(4, 16, seed=1)
    with pytest.raises(ValueError):
        ops.gf_matmul(ref.cauchy_matrix(4, 2), cells[:3], device="cpu")
    with pytest.raises(ValueError):
        ops.ec_parity_delta(4, 2, [4], cells[:1], device="cpu")
    with pytest.raises(ValueError):
        ops.ec_parity_delta(4, 2, [0, 1], cells[:1], device="cpu")
    assert tuple(ops.ec_encode(cells[:, :0], 2, device="cpu").shape) \
        == (2, 0)
    assert tuple(ops.ec_decode(cells, [0, 1, 2, 3], 4, 2,
                               device="cpu").shape) == (0, 16)


def test_card_is_the_default_device():
    """An array with no device asks for the card: without one it raises
    instead of dropping to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ops.ec_encode(_cells(4, 16, seed=2), 2)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    """On the card, the hand-written kernel against the plain version for
    the geometries and widths above: encode, every p-loss decode, and a
    one-cell delta (more shapes in tests/test_torch_cuda.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.kernels.rs_parity import kernel as K
    for k, p in GEOMETRIES:
        for n in WIDTHS:
            cells = torch.from_numpy(_cells(k, n, seed=k + n)).cuda()
            mats = [ref.cauchy_matrix(k, p),
                    np.ascontiguousarray(ref.cauchy_matrix(k, p)[:, :1])]
            for lost in itertools.combinations(range(k + p), p):
                present = [i for i in range(k + p) if i not in lost][:k]
                missing = [i for i in lost if i < k]
                if missing:
                    mats.append(ref.decode_matrix(k, p, present, missing))
            for mat in mats:
                x = cells[:mat.shape[1]].contiguous()
                assert torch.equal(K.rs_matmul(mat, x),
                                   ref.gf_matmul_torch(mat, x))
