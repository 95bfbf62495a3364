"""The port's device-direct placement against the reference's.

The same file (made with numpy from a seed) is written through a
reference client and a port client; both sinks place the same mixed-dtype,
odd-sized tensors — packed back to back, so many start at byte offsets
that are not multiples of their element size. The arrays and the
`DirectStats` must be equal. The port's "device" here is the CPU;
tests/test_torch_cuda.py places into the card.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core.client import ROS2Client as RefClient
from repro.core.device_direct import DeviceDirectSink as RefSink
from repro.core.device_direct import staged_read_tensor as ref_staged
from repro_torch.core import ROS2Client
from repro_torch.core.device_direct import (DeviceDirectSink,
                                            staged_read_tensor)

FILE_BYTES = 3 << 20
SLOT = 64 << 10
DTYPES = [np.float32, np.float16, np.int32, np.int16, np.uint8, np.int8]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain PyTorch versions run on small tensors, fastest on one
    thread; the suite's other workers keep their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(seed):
    """[(offset, shape, dtype)]: odd shapes of mixed dtypes at odd file
    offsets, sized so several slots fill and one tensor fills a slot."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(40):
        dt = np.dtype(DTYPES[i % len(DTYPES)])
        shape = tuple(int(x) for x in rng.integers(1, 40, int(rng.integers(
            1, 4))))
        nbytes = int(np.prod(shape)) * dt.itemsize
        off = int(rng.integers(0, FILE_BYTES - nbytes))
        reqs.append((off, shape, dt))
    reqs.append((12345, (SLOT // 4,), np.dtype(np.float32)))  # a full slot
    return reqs


def _misaligned(reqs):
    """How many tensors the sinks' greedy back-to-back packing starts at
    an offset in their slot that is not a multiple of the element size."""
    pos = n = 0
    for _off, shape, dt in reqs:
        size = int(np.prod(shape)) * dt.itemsize
        if pos + size > SLOT:
            pos = 0
        n += bool(pos % dt.itemsize)
        pos += size
    return n


def _clients(mode, data):
    out = []
    for cls, kw in ((RefClient, {}), (ROS2Client, {"device": "cpu"})):
        c = cls(mode=mode, transport="rdma", scrub_interval_s=None, **kw)
        fd = c.open("/t", create=True)
        c.pwrite(fd, data, 0)
        out.append((c, fd))
    return out


def _assert_same(port, ref):
    assert isinstance(port, torch.Tensor) and port.device.type == "cpu"
    want = np.asarray(ref)
    assert port.numpy().dtype == want.dtype
    np.testing.assert_array_equal(port.numpy(), want)


@pytest.mark.parametrize("mode", ["host", "dpu"])
def test_read_tensors_match_reference(mode):
    data = np.random.default_rng(1).bytes(FILE_BYTES)
    reqs = _requests(seed=2)
    assert _misaligned(reqs) >= 5
    (rc, rfd), (pc, pfd) = _clients(mode, data)
    try:
        rsink, psink = RefSink(rc, SLOT, n_slots=2), \
            DeviceDirectSink(pc, SLOT, n_slots=2)
        ref_out = rsink.read_tensors([(rfd, o, s, d) for o, s, d in reqs])
        out = psink.read_tensors([(pfd, o, s, d) for o, s, d in reqs])
        for (off, shape, dt), got, want in zip(reqs, out, ref_out):
            _assert_same(got, want)
            src = np.frombuffer(data, dt, int(np.prod(shape)), off)
            np.testing.assert_array_equal(got.numpy().reshape(-1), src)
        assert asdict(psink.stats) == asdict(rsink.stats)
        assert psink.stats.batches > 2
        # single-tensor and staged placement agree too
        for off, shape, dt in reqs[:6]:
            _assert_same(psink.read_tensor(pfd, off, shape, dt),
                         rsink.read_tensor(rfd, off, shape, dt))
            _assert_same(staged_read_tensor(pc, pfd, off, shape, dt),
                         ref_staged(rc, rfd, off, shape, dt))
        assert asdict(psink.stats) == asdict(rsink.stats)
        rsink.close()
        psink.close()
        assert not pc.client_registry._rkeys
        assert not pc.client_registry.regions()
    finally:
        rc.close()
        pc.close()


def test_placed_tensors_do_not_alias_the_ring():
    """Slots are reused as soon as their copy is done: tensors handed back
    earlier keep their bytes when later reads refill the ring."""
    data = np.random.default_rng(4).bytes(1 << 20)
    c = ROS2Client(mode="host", transport="rdma", scrub_interval_s=None,
                   device="cpu")
    try:
        fd = c.open("/t", create=True)
        c.pwrite(fd, data, 0)
        with DeviceDirectSink(c, slot_bytes=4096, n_slots=2) as sink:
            first = sink.read_tensors([(fd, 0, (1024,), np.float32)])[0]
            keep = first.view(torch.uint8).clone()
            sink.read_tensors([(fd, 4096 * i, (1024,), np.float32)
                               for i in range(1, 8)])
            assert torch.equal(first.view(torch.uint8), keep)
            with pytest.raises(ValueError):
                sink.read_tensor(fd, 0, (4097,), np.uint8)
    finally:
        c.close()


def test_sink_follows_the_client_device():
    c = ROS2Client(mode="host", transport="rdma", scrub_interval_s=None,
                   device="cpu")
    try:
        with DeviceDirectSink(c, slot_bytes=1024) as sink:
            assert sink.device == torch.device("cpu")
            assert not sink._host.is_pinned()
            assert sink.ring.buf.ctypes.data == sink._host.data_ptr()
    finally:
        c.close()
