"""The async layer against the reference: `CompletionHandle`, the
completion queue, the submission ring and submit/reap of `core/client.py`,
through `_ServerIO`, `_ClusterRouter` and `ROS2Client`'s `submit_pread`,
`submit_preadv` and `submit_pwritev` (reference: `tests/test_async_cq.py`).

Each deterministic scenario is replayed through `repro.core` and
`repro_torch.core` (`device="cpu"`); `same` holds equal every reaped byte,
what each target holds after (`placed`), the counters and the RPC counts,
and within each package a blocking op equals its submit plus wait, bit for
bit. The dpu doorbell batching, `poll`'s cap and the submission ring's
bound are counted the same way.

Thread timing decides these outcomes, so the port keeps the reference
test's assertions only: cancel while pending, a deadline on a pending and
on a running handle, poll order, `wait_any`, overlap under `io_depth`, the
router's per-target rings, close with work in flight and an erroring
handle (`test_lifecycle_*`).
"""
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

from _torch_parity import (DOMAINS8, PORT, counters, image, no_leaks,
                           payload, placed, same, serial_router,
                           storage_env)  # noqa: F401

CONFIGS = {
    "host-rdma": dict(mode="host", transport="rdma"),
    "host-tcp": dict(mode="host", transport="tcp"),
    "dpu-rdma": dict(mode="dpu", transport="rdma"),
    "striped-rdma": dict(mode="host", transport="rdma", n_targets=3),
    "ec42-enc": dict(mode="host", transport="rdma", n_targets=8,
                     domains=DOMAINS8, ec=(4, 2), inline_encryption=True),
}
# thread timing: how many handles the window held at once
TIMING = {"cq.inflight_peak"}


def submit_vs_sync(pkg, name):
    """A seeded mix of submits, each reaped at once, and the same reads
    blocking; every reaped value, the blocking ones, the counters and what
    each target holds."""
    c = pkg.Client(io_depth=8, **CONFIGS[name])
    if c.cluster is not None and len(c.cluster.targets) > 1:
        serial_router(c)
    out = {"async": [], "sync": []}
    try:
        fd = c.open("/cq", create=True)
        rng = np.random.default_rng(3)
        size = 3 << 20
        out["n"] = [c.submit_pwritev(fd, [payload(size, seed=3)], 0).wait()]
        for i in range(12):
            off = int(rng.integers(0, size - 1))
            n = int(rng.integers(1, min(600_000, size - off) + 1))
            cut = max(1, n // 3)
            kind = i % 3
            if kind == 0:
                w = payload(n, seed=100 + i)
                out["n"].append(
                    c.submit_pwritev(fd, [w[:cut], w[cut:]], off).wait())
                out["n"].append(c.pwritev(fd, [w[cut:]], off + cut))
            elif kind == 1:
                out["async"].append(c.submit_pread(fd, n, off).wait())
                out["sync"].append(c.pread(fd, n, off))
            else:
                out["async"].append(
                    b"".join(c.submit_preadv(fd, [cut, n - cut], off).wait()))
                out["sync"].append(b"".join(c.preadv(fd, [cut, n - cut],
                                                     off)))
        assert out["async"] == out["sync"]
        c.close_fd(fd)
        ctr = counters(c)
        cq = c.io.cq.counters()
        assert cq["completed"] == cq["submitted"] - cq["cancelled"]
        out["counters"] = {k: v for k, v in ctr.items()
                           if k not in TIMING}
        out["placed"] = placed(image(c))
        out["rpcs"] = c.control.rpc_count
        no_leaks(c)
        return out
    finally:
        c.close()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_submit_plus_wait_matches_reference(name):
    got = same(submit_vs_sync, name)
    assert got["counters"]["cq.submitted"] >= 9


def doorbells(pkg):
    c = pkg.Client(mode="dpu", transport="rdma", io_depth=4)
    try:
        fd = c.open("/cq-dpu", create=True)
        data = payload(64 * 1024, seed=11)
        c.pwrite(fd, data, 0)
        rung = []
        before = c.dpu.doorbells
        hs = [c.submit_pread(fd, 4096, i * 4096) for i in range(4)]
        rung.append(c.dpu.doorbells - before)
        reads = [h.wait() for h in hs]
        before = c.dpu.doorbells
        h1 = c.submit_pread(fd, 4096, 0)
        h2 = c.submit_pread(fd, 4096, 4096)
        rung.append(c.dpu.doorbells - before)
        reads += [h1.wait(), h2.wait()]
        rung.append(c.dpu.doorbells - before)
        h3 = c.submit_pread(fd, 4096, 0)
        cancelled = h3.cancel()
        with pytest.raises(CancelledError):
            h3.wait()
        cq = {k: v for k, v in c.io.cq.counters().items()
              if f"cq.{k}" not in TIMING}
        return {"rung": rung, "reads": reads, "cancelled": cancelled,
                "cq": cq}
    finally:
        c.close()


def test_dpu_doorbell_batching_matches_reference():
    got = same(doorbells)
    assert got["rung"] == [1, 0, 1] and got["cancelled"]


def poll_and_ring(pkg):
    """poll(n) over settled handles, and the submission ring's bound."""
    c = pkg.Client(mode="host", transport="rdma", io_depth=4)
    try:
        fd = c.open("/cq-poll", create=True)
        data = payload(64 * 1024, seed=14)
        c.pwrite(fd, data, 0)
        empty = c.io.cq.poll()
        hs = [c.submit_pread(fd, 4096, i * 4096) for i in range(4)]
        c.io.cq.drain()
        first, rest = c.io.cq.poll(2), c.io.cq.poll()
        assert set(first + rest) == set(hs)
        reads = [h.wait() for h in hs]
        after = c.io.cq.poll()
        h = c.submit_pread(fd, 4096, 0)
        reads.append(h.wait())
        out = {"empty": empty, "polled": [len(first), len(rest)],
               "after": [after, c.io.cq.poll()], "reads": reads}
    finally:
        c.close()
    ring = pkg.client._SubmissionRing(3, pkg.faults.Timeouts(
        op_deadline_s=0.05))
    for _ in range(3):
        ring.acquire()
    with pytest.raises(pkg.faults.OpTimeout) as ei:
        ring.acquire(timeout=0.05)
    out["full"] = "submission ring full" in str(ei.value)
    ring.release()
    ring.acquire()
    out["peak"] = ring.peak
    return out


def test_poll_and_submission_ring_match_reference():
    got = same(poll_and_ring)
    assert got["polled"] == [2, 2] and got["peak"] == 3 and got["full"]


# ---------------------------------------------------------------------------
# Lifecycles thread timing decides: the reference test's assertions


def _host(io_depth=8, **kw):
    return PORT.Client(mode="host", transport="rdma", io_depth=io_depth,
                       **kw)


class _SlowReads:
    """Gate a session's read impl; `started` releases once a read entered
    it, so a test can wait until the pool workers are provably busy."""

    def __init__(self, io):
        self.io = io
        self.gate = threading.Event()
        self.started = threading.Semaphore(0)
        self._orig = io._read_impl

    def __enter__(self):
        def slow(*a, **kw):
            self.started.release()
            assert self.gate.wait(10.0)
            return self._orig(*a, **kw)
        self.io._read_impl = slow
        return self

    def __exit__(self, *exc):
        self.gate.set()
        self.io._read_impl = self._orig
        return False


def _busy(slow, n=2):
    for _ in range(n):
        assert slow.started.acquire(timeout=10.0)


def test_lifecycle_cancel_and_deadlines():
    OpTimeout = PORT.faults.OpTimeout
    c = _host(io_depth=2)
    try:
        fd = c.open("/cq", create=True)
        want = payload(64 * 1024, seed=6)
        c.pwrite(fd, want, 0)
        with _SlowReads(c.io) as slow:
            hs = [c.submit_pread(fd, 4096, i * 4096) for i in range(4)]
            _busy(slow)
            assert hs[2].cancel() and hs[3].cancel()
            assert not hs[3].cancel()
            slow.gate.set()
            assert not hs[0].cancel()
            hs[0].wait(), hs[1].wait()
        for h in hs[2:]:
            with pytest.raises(CancelledError):
                h.wait()
        with _SlowReads(c.io) as slow:
            hs = [c.submit_pread(fd, 4096, 0) for _ in range(3)]
            _busy(slow)
            with pytest.raises(OpTimeout) as ei:
                hs[2].wait(timeout=0.05)
            assert "cancelled in place" in str(ei.value) and hs[2].done()
            slow.gate.set()
            hs[0].wait(), hs[1].wait()
        with _SlowReads(c.io) as slow:
            h = c.submit_pread(fd, 4096, 0)
            _busy(slow, 1)
            with pytest.raises(OpTimeout) as ei:
                h.wait(timeout=0.05)
            assert "drains in background" in str(ei.value)
            assert not h.done()
            slow.gate.set()
            assert h.wait() == want[:4096]
        cq = c.io.cq.counters()
        assert cq["cancelled"] == 3
        assert cq["completed"] == cq["submitted"] - 3
        assert c.io.cq.inflight() == 0
    finally:
        c.close()


def test_lifecycle_poll_order_and_wait_any():
    OpTimeout = PORT.faults.OpTimeout
    c = _host(io_depth=2)
    try:
        fd = c.open("/cq", create=True)
        data = payload(32 * 1024, seed=16)
        c.pwrite(fd, data, 0)
        with _SlowReads(c.io) as slow:
            hs = [c.submit_pread(fd, 4096, 0) for _ in range(3)]
            _busy(slow)
            assert hs[2].cancel()
            assert c.io.cq.poll() == [hs[2]]
            slow.gate.set()
            hs[0].wait(), hs[1].wait()
        with pytest.raises(CancelledError):
            hs[2].wait()
        assert c.io.cq.wait_any([]) == []
        with _SlowReads(c.io) as slow:
            hs = [c.submit_pread(fd, 4096, i * 4096) for i in range(2)]
            _busy(slow)
            with pytest.raises(OpTimeout) as ei:
                c.io.cq.wait_any(hs, timeout=0.05)
            assert "cq.wait_any" in str(ei.value)
            slow.gate.set()
            done = c.io.cq.wait_any(hs)
            assert done and set(done) <= set(hs)
        for i, h in enumerate(hs):
            assert h.wait() == data[i * 4096:(i + 1) * 4096]
        assert c.io.cq.inflight() == 0
    finally:
        c.close()


def test_lifecycle_overlap_and_router_rings():
    c = _host(io_depth=8)
    try:
        fd = c.open("/cq", create=True)
        data = payload(256 * 1024, seed=5)
        c.pwrite(fd, data, 0)
        hs = [(c.submit_pread(fd, 16 * 1024, i * 16 * 1024), i)
              for i in range(16)]
        for h, i in hs:
            assert h.wait() == data[i * 16 * 1024:(i + 1) * 16 * 1024]
        cq = c.io.data_path_counters()["cq"]
        assert cq["inflight_peak"] >= 2 and cq["cancelled"] == 0
        assert cq["completed"] == cq["submitted"]
    finally:
        c.close()
    c = PORT.Client(mode="host", transport="rdma", n_targets=3, io_depth=4)
    try:
        fd = c.open("/cq", create=True)
        data = payload(512 * 1024, seed=10)
        c.pwrite(fd, data, 0)
        hs = [c.submit_pread(fd, 32 * 1024, i * 32 * 1024)
              for i in range(16)]
        for i, h in enumerate(hs):
            assert h.wait() == data[i * 32 * 1024:(i + 1) * 32 * 1024]
        for ring in c.io._rings.values():
            assert ring.peak <= c.io.io_depth and ring._inflight == 0
        assert c.io.data_path_counters()["cq"]["submitted"] >= 17
    finally:
        c.close()


def test_lifecycle_close_in_flight_and_erroring_handle():
    from tools.analysis.leakwitness import client_leaks
    c = _host(io_depth=4)
    fd = c.open("/cq", create=True)
    c.pwrite(fd, payload(128 * 1024, seed=9), 0)
    orig = c.io._read_impl

    def slowish(*a, **kw):
        time.sleep(0.02)
        return orig(*a, **kw)
    c.io._read_impl = slowish
    hs = [c.submit_pread(fd, 4096, i * 4096) for i in range(8)]
    c.close()
    assert c.io.cq.inflight() == 0 and all(h.done() for h in hs)
    assert client_leaks(c, timeout=1.0) == []
    c = _host(io_depth=4)
    fd = c.open("/cq", create=True)
    c.pwrite(fd, payload(16 * 1024, seed=13), 0)
    orig = c.io._read_impl
    armed = [True]

    def flaky(*a, **kw):
        if armed.pop() if armed else False:
            raise IOError("injected async read failure")
        return orig(*a, **kw)
    c.io._read_impl = flaky
    bad = c.submit_pread(fd, 4096, 0)
    good = c.submit_pread(fd, 4096, 4096)
    with pytest.raises(IOError, match="injected async read"):
        bad.wait()
    good.wait()
    c.io._read_impl = orig
    cq = c.io.cq.counters()
    assert cq["completed"] == cq["submitted"]
    c.close()
    assert client_leaks(c, timeout=1.0) == []
    no_leaks(c)
