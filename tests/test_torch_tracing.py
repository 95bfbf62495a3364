"""The port's span tracer (`repro_torch.common.tracing`) and its spans in
the SmartNIC runtime, the read path and the serving engine, on the CPU:
off, it records nothing; on, every SQE of a DPU-mode encrypted ec(4,2)
read has its queue, Arm-core and completion spans under its tag, with the
read path's stages nested in its op; an engine wave records one decode
step a step; a span maps onto the profiler's clock; and tracing changes
neither the bytes read nor the data-path counters."""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.common import tracing
from repro_torch.core.client import ROS2Client

DOMAINS8 = ["a", "a", "b", "b", "c", "c", "d", "d"]
READ = 512
N_READS = 64
POOL = 2 << 20


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    tracing.collect()
    yield
    tracing.disable()
    tracing.collect()


def _client(**kw):
    return ROS2Client(mode="dpu", transport="rdma", n_targets=8,
                      domains=DOMAINS8, ec=(4, 2), n_devices=4,
                      inline_encryption=True, scrub_interval_s=None,
                      device="cpu", **kw)


def _filled(client):
    data = np.random.default_rng(5).integers(0, 256, POOL, dtype=np.uint8)
    fd = client.open("/pool", create=True)
    client.pwrite(fd, data.tobytes(), 0)
    return fd, data.tobytes()


def _offsets(n=N_READS, seed=9):
    return [int(o) * READ for o in
            np.random.default_rng(seed).integers(0, POOL // READ, n)]


def _by_id(spans):
    return {s.id: s for s in spans}


def _ancestors(s, ids):
    while s.parent:
        s = ids[s.parent]
        yield s


def test_off_records_nothing():
    assert not tracing.ON
    assert tracing.span("a") is tracing.span("b", 3, True, op="x") \
        is tracing.NOOP
    assert tracing.current_trace() is None
    tracing.interval("dpu.queue", 1, 2, 7)
    c = _client(io_depth=16)
    try:
        fd, data = _filled(c)
        hs = [c.submit_pread(fd, READ, o) for o in _offsets(16)]
        assert [h.wait() for h in hs] == [data[o:o + READ]
                                         for o in _offsets(16)]
        assert c.pread(fd, READ, 0) == data[:READ]
    finally:
        c.close()
    assert tracing.collect() == []


def test_dpu_reads_record_queue_op_and_completion_under_their_tags():
    c = _client(io_depth=16)
    try:
        fd, data = _filled(c)
        offs = _offsets()
        tracing.enable()
        hs = [c.submit_pread(fd, READ, o) for o in offs]
        got = [h.wait() for h in hs]
        clock = tracing.disable()
        spans = tracing.collect()
    finally:
        c.close()
    assert got == [data[o:o + READ] for o in offs]
    assert abs(clock["drift_ns"]) < 50_000_000
    tags = sorted(h._tag for h in hs)
    assert len(set(tags)) == N_READS
    named = {}
    for s in spans:
        named.setdefault(s.name, []).append(s)
    # one of each a SQE, none lost from the 16 Arm cores
    for name in ("dpu.queue", "dpu.op", "dpu.complete", "dpu.wait"):
        assert sorted(s.trace for s in named[name]) == tags, name
    assert all(s.interval for s in named["dpu.queue"] + named["dpu.complete"])
    ops = named["dpu.op"]
    assert all(s.attrs == {"op": "read"} and s.cpu_ns is not None
               and s.t0 <= s.t1 for s in ops)
    assert len({s.tid for s in ops}) <= 16
    # a queue wait ends before its op starts, on the op's Arm core
    queue = {s.trace: s for s in named["dpu.queue"]}
    for op in ops:
        q = queue[op.trace]
        assert q.tid == op.tid and q.t0 <= q.t1 <= op.t0
    ids = _by_id(spans)
    # the read path's stages lie inside their read's op
    for name in ("ec.gather", "ec.drain", "ec.target", "session.fetch",
                 "crypto.apply"):
        assert len(named[name]) >= N_READS, name
        for s in named[name]:
            up = [a for a in _ancestors(s, ids) if a.name == "dpu.op"]
            assert len(up) == 1 and up[0].trace == s.trace, name
            assert up[0].t0 <= s.t0 <= s.t1 <= up[0].t1
    for s in named.get("crypto.page", []):
        assert ids[s.parent].name == "crypto.apply"
    # a completion is claimed inside its waiter's wait, on the host
    waits = {s.id: s for s in named["dpu.wait"]}
    host = threading.get_ident()
    for s in named["dpu.complete"]:
        w = waits[s.parent]
        assert w.trace == s.trace and s.tid == w.tid == host
        assert s.t1 <= w.t1


def test_sync_dpu_read_records_its_open_and_read():
    c = ROS2Client(mode="dpu", transport="rdma", replication=2,
                   scrub_interval_s=None, device="cpu")
    try:
        fd = c.open("/obj", create=True)
        c.pwrite(fd, b"x" * 4096, 0)
        tracing.enable()
        fd = c.open("/obj")
        assert c.pread(fd, 4096, 0) == b"x" * 4096
        tracing.disable()
        spans = tracing.collect()
    finally:
        c.close()
    ops = sorted((s for s in spans if s.name == "dpu.op"),
                 key=lambda s: s.t0)
    assert [s.attrs["op"] for s in ops] == ["open", "read"]
    for name in ("dpu.queue", "dpu.complete", "dpu.wait"):
        assert sorted(s.trace for s in spans if s.name == name) == sorted(
            s.trace for s in ops)
    ids = _by_id(spans)
    fetch = [s for s in spans if s.name == "session.fetch"]
    assert fetch and all(
        any(a.name == "dpu.op" for a in _ancestors(s, ids)) for s in fetch)


def test_tracing_leaves_bytes_and_counters_unchanged():
    def run(on):
        c = _client()
        try:
            fd, _ = _filled(c)
            if on:
                tracing.enable()
            got = [c.pread(fd, READ, o) for o in _offsets(24)]
            got.append(c.pread(fd, 3 * READ, POOL - 3 * READ))
            tracing.disable()
            return got, c.io.data_path_counters(), tracing.collect()
        finally:
            c.close()

    off, on = run(False), run(True)
    assert off[0] == on[0]
    assert off[1] == on[1]
    assert off[2] == [] and len(on[2]) > 24 * 5


def test_engine_wave_records_a_decode_step_a_step():
    from repro_torch.configs import tiny_config
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.launch.serve import BatchedEngine, Request
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.params import init_params

    cfg = tiny_config("granite-3-2b")
    api = ModelAPI(cfg, device="cpu")
    params = init_params(api.param_defs(),
                         torch.Generator().manual_seed(0), torch.float32,
                         "cpu")
    eng = BatchedEngine(api, params, make_host_mesh_ctx(cfg, device="cpu"),
                        batch=3, prompt_len=8, max_seq=24)
    rng = np.random.default_rng(1)
    eng.run_wave([Request(9, rng.integers(0, cfg.vocab, 8, dtype=np.int32),
                          2)])
    tracing.enable()
    reqs = [Request(i, rng.integers(0, cfg.vocab, 8, dtype=np.int32), n)
            for i, n in ((4, 5), (5, 2), (6, 3))]
    eng.run_wave(reqs)
    tracing.disable()
    spans = tracing.collect()
    steps = eng.steps
    ids = _by_id(spans)
    wave, = [s for s in spans if s.name == "engine.wave"]
    assert wave.trace == 1 and wave.attrs == {"rids": [4, 5, 6],
                                              "new": [5, 2, 3]}
    assert all(s.trace == 1 for s in spans)

    def children(parent):
        return [s.name for s in sorted(spans, key=lambda s: s.t0)
                if s.parent == parent.id]

    prefill, = [s for s in spans if s.name == "engine.prefill"]
    assert prefill.parent == wave.id
    assert children(prefill) == ["prefill.stack", "prefill.replay",
                                 "prefill.token_read"]
    dsteps = sorted((s for s in spans if s.name == "decode.step"),
                    key=lambda s: s.t0)
    # the first wave took one step, this one four (its longest asks for 5)
    assert len(dsteps) == 4 == steps - 1
    for s in dsteps:
        assert ids[s.parent] is wave
        assert children(s) == ["decode.replay", "decode.token_read",
                               "decode.bookkeep"]
    assert [len(r.out) for r in reqs] == [5, 2, 3]


def test_span_maps_inside_its_profiler_range():
    from torch.profiler import ProfilerActivity, profile, record_function
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("anchor"):
                time.sleep(0.001)
                with tracing.span("inner"):
                    time.sleep(0.002)
                time.sleep(0.001)
    clock = tracing.disable()
    inner = sorted((s for s in tracing.collect() if s.name == "inner"),
                   key=lambda s: s.t0)
    anchors = sorted((ev.start_ns(), ev.end_ns())
                     for ev in prof.profiler.kineto_results.events()
                     if ev.name() == "anchor")
    assert len(inner) == len(anchors) == 3
    for s, (a, b) in zip(inner, anchors):
        t0 = tracing.to_trace_clock(s.t0, clock)
        t1 = tracing.to_trace_clock(s.t1, clock)
        assert t0 == s.t0 + clock["offset_ns"] == tracing.to_trace_clock(s.t0)
        assert a <= t0 <= t1 <= b


def test_spans_from_many_threads_are_all_collected():
    import sys
    n_threads, per = 24, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    tracing.enable()
    try:
        def work(k):
            for i in range(per):
                with tracing.span("outer", k):
                    with tracing.span("inner"):
                        pass
                    tracing.interval("wait", 1, 2, k)

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        tracing.disable()
        sys.setswitchinterval(old)
    spans = tracing.collect()
    assert len(spans) == 3 * n_threads * per
    assert len({s.id for s in spans}) == len(spans)
    ids = _by_id(spans)
    for s in spans:
        if s.name != "outer":
            p = ids[s.parent]
            assert p.name == "outer" and p.tid == s.tid
            assert s.trace == p.trace
    # the ended threads' lists are dropped once drained
    assert tracing.collect() == []
