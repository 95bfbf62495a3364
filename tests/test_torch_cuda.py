"""The port on the CUDA card: the hand-written kernel against its plain
version, device-direct placement into GPU memory, and the EC path's
parity legs through the kernel. Every test here needs a card and skips
without one; on the card run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports neither JAX nor the reference package, so it runs where
only PyTorch is installed.
"""
import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from repro_torch.core import ROS2Client
from repro_torch.core.device_direct import DeviceDirectSink
from repro_torch.kernels.rs_parity import kernel as K
from repro_torch.kernels.rs_parity import ops
from repro_torch.kernels.rs_parity import ref

MiB = 1 << 20
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_kernel_matches_plain_version_on_card(cuda_device):
    """rs_matmul against its plain version and the numpy oracle: encode,
    decode, delta, ragged widths and an unaligned start."""
    rng = np.random.default_rng(5)
    cases = [(ref.cauchy_matrix(4, 2), 262144),
             (ref.cauchy_matrix(8, 3), 131072),
             (ref.decode_matrix(4, 2, [0, 1, 4, 5], [2, 3]), 4096),
             (np.ascontiguousarray(ref.cauchy_matrix(4, 2)[:, [1, 3]]), 1000),
             (rng.integers(0, 256, (11, 11), np.uint8), 333)]
    cases += [(ref.cauchy_matrix(4, 2), n) for n in (1, 15, 4097)]
    for mat, n in cases:
        x = torch.from_numpy(rng.integers(0, 256, (mat.shape[1], n),
                                          np.uint8)).to(cuda_device)
        got = K.rs_matmul(mat, x)
        torch.cuda.synchronize()
        assert torch.equal(got, ref.gf_matmul_torch(mat, x))
        np.testing.assert_array_equal(got.cpu().numpy(), ref.gf_matmul_np(
            mat, x.cpu().numpy()))
    flat = torch.from_numpy(rng.integers(0, 256, 1 + 4 * 4097,
                                         np.uint8)).to(cuda_device)
    x = flat[1:].view(4, 4097)
    assert x.data_ptr() % 16
    got = K.rs_matmul(ref.cauchy_matrix(4, 2), x)
    assert torch.equal(got, ref.gf_matmul_torch(ref.cauchy_matrix(4, 2), x))
    with pytest.raises(ValueError):
        K.rs_matmul(rng.integers(0, 256, (12, 4), np.uint8), x)
    with pytest.raises(ValueError):
        K.rs_matmul(ref.cauchy_matrix(4, 2), x.cpu())


def test_ops_count_launches_by_leg(cuda_device):
    cells = np.random.default_rng(6).integers(0, 256, (4, 4096), np.uint8)
    before = ops.launches()
    parity = ops.ec_encode(cells, 2)
    assert parity.device.type == "cuda"
    ops.ec_parity_delta(4, 2, [1], cells[1:2])
    ops.ec_decode(np.concatenate([cells[:3], parity[:1].cpu().numpy()]),
                  [0, 1, 2, 4], 4, 2)
    after = ops.launches()
    assert {leg: after[leg] - before[leg] for leg in after} \
        == {"encode": 1, "delta": 1, "decode": 1, "matmul": 0}


def test_concurrent_launches_are_all_counted(cuda_device):
    """The EC path launches from several pools at once: with more threads
    than cores and a short switch interval, every launch is counted and
    every result is right."""
    rng = np.random.default_rng(9)
    cells = [rng.integers(0, 256, (4, 4096), np.uint8) for _ in range(256)]
    before = ops.launches()["encode"]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=2 * (os.cpu_count() or 4),
                                thread_name_prefix="rs-stress") as pool:
            outs = list(pool.map(lambda x: ops.ec_encode(x, 2), cells,
                                 timeout=120))
    finally:
        sys.setswitchinterval(old)
    torch.cuda.synchronize()
    for x, out in zip(cells, outs):
        np.testing.assert_array_equal(out.cpu().numpy(), ref.rs_encode_np(x, 2))
    assert ops.launches()["encode"] - before == len(cells)


def test_ec_path_runs_every_leg_through_the_kernel(cuda_device):
    """A small ec(4,2) run on the card: write, one-cell overwrite, degraded
    read, outage write, rebuild and scrub — bit-exact, with encode, delta
    and decode launches counted."""
    rng = np.random.default_rng(7)
    data = bytearray(rng.bytes(8 * MiB))
    c = ROS2Client(mode="host", transport="rdma", n_targets=8,
                   domains=["a", "a", "b", "b", "c", "c", "d", "d"],
                   ec=(4, 2), inline_encryption=True, scrub_interval_s=None)
    ops.reset_launches()
    try:
        fd = c.open("/f", create=True)
        c.pwrite(fd, bytes(data), 0)
        cell = rng.bytes(MiB // 4)
        c.pwrite(fd, cell, MiB + MiB // 4)
        data[MiB + MiB // 4:MiB // 2 + MiB] = cell
        c.cluster.fail_target(2)
        assert c.pread(fd, len(data), 0) == data
        out = rng.bytes(2 * MiB)
        c.pwrite(fd, out, 4 * MiB)
        data[4 * MiB:6 * MiB] = out
        c.cluster.recover_target(2)
        assert c.pread(fd, len(data), 0) == data
        scrub = c.scrubber.scrub_parity(64 * MiB)
        assert scrub["parity_checks"] > 0 and scrub["parity_mismatches"] == 0
        ec = c.io.data_path_counters()["ec"]
        assert ec["delta_writes"] >= 1 and ec["reconstructions"] > 0
        assert ec["rebuilt_cells"] > 0
    finally:
        c.close()
    n = ops.launches()
    assert n["encode"] > 0 and n["delta"] > 0 and n["decode"] > 0


def test_read_tensors_land_on_card(cuda_device):
    """Mixed dtypes packed back to back (misaligned starts included)
    placed from the pinned ring into GPU memory, byte for byte."""
    rng = np.random.default_rng(8)
    data = rng.bytes(3 * MiB)
    dtypes = [np.float32, np.float16, np.int32, np.int16, np.uint8]
    reqs = []
    for i in range(30):
        dt = np.dtype(dtypes[i % len(dtypes)])
        shape = tuple(int(x) for x in rng.integers(1, 40, 2))
        off = int(rng.integers(0, len(data) - 40 * 40 * 4))
        reqs.append((off, shape, dt))
    c = ROS2Client(mode="host", transport="rdma", scrub_interval_s=None)
    try:
        fd = c.open("/t", create=True)
        c.pwrite(fd, data, 0)
        with DeviceDirectSink(c, 64 << 10, n_slots=2) as sink:
            assert sink._host.is_pinned()
            out = sink.read_tensors([(fd, o, s, d) for o, s, d in reqs])
            one = sink.read_tensor(fd, *reqs[1])
        assert torch.equal(one.view(torch.uint8), out[1].view(torch.uint8))
        for (off, shape, dt), got in zip(reqs, out):
            assert got.device.type == "cuda"
            assert tuple(got.shape) == shape
            nbytes = int(np.prod(shape)) * dt.itemsize
            src = torch.frombuffer(bytearray(data[off:off + nbytes]),
                                   dtype=torch.uint8)
            assert torch.equal(got.reshape(-1).view(torch.uint8).cpu(), src)
    finally:
        c.close()
