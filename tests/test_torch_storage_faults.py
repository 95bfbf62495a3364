"""The fault layer against the reference: `core/faults.py` (the seeded
`FaultInjector`, `Timeouts`, backoff and jitter), the router's surgical
retries and error-path lease hygiene, the per-class fault/recovery gates
and heal pacing (reference: `tests/test_fault_storage.py`), then
`distributed/fault.py` and `core/counters_registry.py` (reference:
`tests/test_fault.py`, `tests/test_static_analysis.py`).

Each scenario is made from numpy seeds and replayed through `repro.core`
and `repro_torch.core` (`device="cpu"`); `same` holds what each observed
equal: rule fires, counters, backoff floats, returned bytes.

Thread timing decides these outcomes, so they keep the reference test's
assertions only: the elapsed time an `OpTimeout` reports
(`test_timeouts_carry_op_context`) and the dispatch deadline
(`test_dispatch_deadline_raises_optimeout`).
"""
import time

import numpy as np
import pytest

from _torch_parity import (PORT, REF, counters, no_leaks, payload, same,
                           storage_env)  # noqa: F401
from repro.core.dfs import BLOCK

BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


# ---------------------------------------------------------------------------
# FaultInjector mechanics


def _rules(pkg):
    Fault = pkg.faults.Fault
    return [("a.b", Fault("error"), 2), ("a.*", Fault("delay"), (1, 1)),
            ("a.c", Fault("partial"), lambda m: m % 3 == 1),
            ("x.*", Fault("drop"), 0.4),
            ("x.y", Fault("expire"), (2, 5))]


def injector_sequence(pkg, seed):
    """Every pick over a seeded op stream, then the counters."""
    inj = pkg.faults.FaultInjector(schedule=_rules(pkg), seed=seed)
    rng = np.random.default_rng(seed)
    ops = ["a.b", "a.c", "x.y", "x.z", "b.a"]
    picks = []
    for _ in range(300):
        f = inj.pick(ops[int(rng.integers(0, len(ops)))])
        picks.append(None if f is None else f.kind)
    inj.arm("nope", pkg.faults.Fault("error"), 1)
    with pytest.raises(pkg.faults.InjectedTransientError):
        inj.fire("nope")
    inj.note_recovery("x")
    return {"picks": picks, "counters": inj.counters()}


@pytest.mark.parametrize("seed", [7, 11, 1234])
def test_injector_fires_on_the_same_matches(seed):
    got = same(injector_sequence, seed)
    assert got["counters"]["total_injected"] > 20
    assert set(got["counters"]["injected_by_kind"]) >= {
        "error", "delay", "partial", "drop", "expire"}


def test_injector_reference_cases():
    def case(pkg):
        Fault = pkg.faults.Fault
        inj = pkg.faults.FaultInjector(schedule=[
            ("a.b", Fault("error"), 2), ("a.*", Fault("delay"), (1, 1))],
            seed=7)
        out = [inj.pick("a.c").kind, inj.pick("a.b")]
        with pytest.raises(pkg.faults.InjectedTransientError):
            inj.fire("a.b")
        inj.note_recovery("x")
        sched = [("op", Fault("error"), 0.3)]
        a = pkg.faults.FaultInjector(schedule=sched, seed=11)
        fires = [a.pick("op") is not None for _ in range(200)]
        return {"out": out, "counters": inj.counters(), "fires": fires}

    got = same(case)
    assert got["out"] == ["delay", None]
    assert got["counters"]["injected_by_kind"] == {"delay": 1, "error": 1}
    assert 20 < sum(got["fires"]) < 120


def backoffs(pkg):
    T = pkg.faults.Timeouts
    t = T(retry_backoff_s=0.05, retry_backoff_cap_s=0.4)
    j = T(retry_backoff_s=0.05, retry_backoff_cap_s=0.4,
          retry_jitter_seed=7)
    return {"cap": [t.backoff_cap(a) for a in range(1, 12)],
            "plain": [t.backoff(a) for a in range(1, 12)],
            "jitter": [j.backoff(a, salt=s) for a in range(1, 12)
                       for s in range(6)],
            "seeds": [T(retry_jitter_seed=s).backoff(3, salt=1)
                      for s in range(5)],
            "default": dict(vars(pkg.faults.DEFAULT_TIMEOUTS))}


def test_backoff_and_jitter_are_the_same_floats():
    got = same(backoffs)
    assert got["cap"][:3] == [0.0, 0.05, 0.1] and got["cap"][-1] == 0.4
    assert got["jitter"][0] == 0.0
    assert len(set(got["seeds"])) == 5


@BOTH
def test_timeouts_carry_op_context(pkg):
    """Timing: the elapsed times are the reference test's bounds."""
    T = pkg.faults.Timeouts
    ring = pkg.client._StagingRing(pkg.data_plane.MemoryRegistry("srv"), 2,
                                   1024, "default",
                                   timeouts=T(staging_acquire_s=0.05),
                                   label="t9")
    held = ring.acquire(2)
    with pytest.raises(pkg.faults.OpTimeout) as ei:
        ring.acquire(1)
    assert ei.value.op == "staging.acquire" and ei.value.target == "t9"
    assert ei.value.elapsed_s >= 0.05
    assert "staging.acquire on t9" in str(ei.value)
    ring.release(held)
    assert ring.acquire(1)
    rec = pkg.object_store._PendingCommit(1, 1, timeouts=T(quorum_s=0.05))
    with pytest.raises(pkg.faults.OpTimeout) as ei:
        rec.wait_quorum()
    assert ei.value.op == "commit.quorum"
    assert "0/1 replicas" in ei.value.detail


@BOTH
def test_client_threads_one_timeouts_policy(pkg):
    t = pkg.faults.Timeouts(staging_acquire_s=17.0)
    c = pkg.Client(mode="host", transport="rdma", n_targets=2, timeouts=t)
    try:
        assert c.timeouts is t and c.cluster.timeouts is t
        assert c.io.timeouts is t
        for s in c.io.sessions.values():
            assert s.ring.timeouts is t
            assert s.container.store.timeouts is t
    finally:
        c.close()


# ---------------------------------------------------------------------------
# Surgical retries and error-path lease hygiene


def surgical_retry(pkg):
    c = pkg.Client(mode="host", transport="rdma", n_targets=2)
    try:
        fd = c.open("/f", create=True)
        data = payload(8 * BLOCK, seed=2)
        calls = {0: 0, 1: 0}
        armed = [True]
        for tid in (0, 1):
            sess = c.io.sessions[tid]

            def counted(o, fo, bufs, _tid=tid, _orig=sess.writev):
                calls[_tid] += 1
                if _tid == 1 and armed[0]:
                    armed[0] = False
                    raise pkg.object_store.TargetDownError("injected")
                return _orig(o, fo, bufs)
            sess.writev = counted
        c.pwrite(fd, data, 0)
        oid = c.dfs.stat("/f")["oid"]
        homes = [pkg.object_store.placement_order(2, oid, str(b))[0]
                 for b in range(8)]
        runs = {0: 0, 1: 0}
        for i, h in enumerate(homes):
            if i == 0 or homes[i - 1] != h:
                runs[h] += 1
        assert calls[0] == runs[0] and calls[1] == 1 + runs[1]
        assert c.io.target_retries == 1 and c.io.retried_runs == runs[1]
        back = c.pread(fd, len(data), 0)
        assert back == data
        no_leaks(c)
        return {"calls": calls, "runs": runs, "counters": counters(c)}
    finally:
        c.close()


def retry_budget(pkg, mode):
    """`mode` "budget": a target that stays down exhausts the retry budget;
    "mid_writev": it fails mid-writev with budget 1; either way the rings
    stay whole and the path heals once the fault clears."""
    T = pkg.faults.Timeouts
    c = pkg.Client(mode="host", transport="rdma", n_targets=2,
                   timeouts=T(retry_budget=2 if mode == "budget" else 1,
                              retry_backoff_s=0.0))
    try:
        fd = c.open("/f", create=True)
        sess = c.io.sessions[1]
        fails = [0]
        orig = sess.writev

        def always_down(o, fo, bufs):
            fails[0] += 1
            raise pkg.object_store.TargetDownError("injected")
        sess.writev = always_down
        with pytest.raises(pkg.object_store.TargetDownError):
            c.pwrite(fd, payload(6 * BLOCK, seed=3), 0)
        no_leaks(c)
        sess.writev = orig
        data = payload(6 * BLOCK, seed=4)
        c.pwrite(fd, data, 0)
        assert c.pread(fd, len(data), 0) == data
        no_leaks(c)
        return {"fails": fails[0], "retries": c.io.target_retries,
                "counters": counters(c)}
    finally:
        c.close()


def test_surgical_retry_redispatches_only_failed_runs():
    same(surgical_retry)


@pytest.mark.parametrize("mode", ["budget", "mid_writev"])
def test_retry_budget_and_lease_hygiene(mode):
    got = same(retry_budget, mode)
    if mode == "budget":
        assert got["fails"] == 3 and got["retries"] == 2


@BOTH
def test_dispatch_deadline_raises_optimeout(pkg):
    """Timing: which retry the 10 ms deadline cuts depends on the clock."""
    T = pkg.faults.Timeouts
    c = pkg.Client(mode="host", transport="rdma", n_targets=2,
                   timeouts=T(op_deadline_s=0.01, retry_budget=100,
                              retry_backoff_s=0.02))
    try:
        fd = c.open("/f", create=True)

        def always_down(o, fo, bufs):
            time.sleep(0.02)
            raise pkg.object_store.TargetDownError("injected")
        c.io.sessions[1].writev = always_down
        with pytest.raises(pkg.faults.OpTimeout) as ei:
            c.pwrite(fd, payload(6 * BLOCK, seed=5), 0)
        assert ei.value.op == "cluster.dispatch"
        assert "t1" in (ei.value.target or "")
        no_leaks(c)
    finally:
        c.close()


# ---------------------------------------------------------------------------
# Per-class fault / recovery gates


def fault_gate(pkg, case):
    """One fault class, armed at a seeded point, and its recovery."""
    Fault = pkg.faults.Fault
    media_err = Fault("error", exc=lambda: IOError("injected media"))
    sched, kw = {
        "transport": ([("transport.write_sg", Fault("error"), 1),
                       ("transport.read_sg", Fault("partial"), 1)],
                      dict(transport="tcp", n_targets=1)),
        "cap_expire": ([("cap.expire", Fault("expire"), 1)],
                       dict(transport="rdma", n_targets=1)),
        "media_read": ([("media.read", media_err, 1)],
                       dict(transport="rdma", n_targets=1, replication=2)),
        "media_abort": ([("media.write", media_err, 1)],
                        dict(transport="rdma", n_targets=1, replication=2)),
        "map_push": ([("map.push", Fault("drop"), 1)],
                     dict(transport="rdma", n_targets=2)),
        "pool_map_rpc": ([], dict(transport="rdma", n_targets=2)),
    }[case]
    inj = pkg.faults.FaultInjector(schedule=sched)
    c = pkg.Client(mode="host", fault_injector=inj, **kw)
    out = {}
    try:
        fd = c.open("/f", create=True)
        if case == "media_abort":
            with pytest.raises(pkg.object_store.StorageError):
                c.pwrite(fd, payload(BLOCK, seed=8), 0)
            no_leaks(c)
        if case == "map_push":
            c.pwrite(fd, payload(4 * BLOCK, seed=13), 0)
            out["refreshes0"] = c.io.map_refreshes
            c.cluster.fail_target(1)
        if case == "pool_map_rpc":
            inj.arm("map.push", Fault("drop"), 1)
            inj.arm("control.rpc.get_pool_map", Fault("drop"), 1)
            c.cluster.fail_target(1)
        data = payload(2 * BLOCK + 77, seed=10)
        out["write"] = c.pwrite(fd, data, 0)
        assert c.pread(fd, len(data), 0) == data
        if case == "cap_expire":
            ent = c.io.sreg._rkeys[c.io.staging_rkey]
            assert ent.expires_at > time.monotonic()
        if len(c.cluster.targets) > 1:
            out["retries"] = (c.io.target_retries, c.io.map_refreshes)
        no_leaks(c)
        out["injector"] = inj.counters()
        out["counters"] = counters(c)
        return out
    finally:
        c.close()


GATES = {"transport": ("transport.retry", 2), "cap_expire": ("cap.renewed", 1),
         "media_read": ("read.degraded_replica", 1),
         "media_abort": (None, 0), "map_push": (None, 0),
         "pool_map_rpc": ("control.rpc_retry", 1)}


@pytest.mark.parametrize("case", list(GATES))
def test_fault_class_recovers_the_same_way(case):
    got = same(fault_gate, case)
    path, n = GATES[case]
    if path:
        assert got["injector"]["recovered"][path] >= n
    if case == "map_push":
        assert got["retries"] == (1, got["refreshes0"] + 1)
    assert got["injector"]["total_injected"] >= 1


# ---------------------------------------------------------------------------
# Idle-aware heal pacing


class _FakePacer:
    idle_aware = True

    def __init__(self, budgets, max_deferrals=3):
        self.budgets = list(budgets)
        self.max_deferrals = max_deferrals

    def idle_budget(self):
        return self.budgets.pop(0) if self.budgets else 0


def heal_pacing(pkg):
    cluster = pkg.Cluster(n_targets=2, n_devices=2)
    try:
        cluster.heal_pause_s = 0.0
        cluster.heal_pacer = _FakePacer([0, 0, 4096])
        cluster._pace_heal(1000)
        first = vars(cluster.stats).copy()
        cluster.heal_pacer = _FakePacer([], max_deferrals=3)
        cluster._pace_heal(500)
        cluster._pace_heal(500)
        return {"first": first, "then": vars(cluster.stats).copy()}
    finally:
        cluster.close()


def test_heal_pacing_defers_then_floor_grants():
    got = same(heal_pacing)
    assert got["first"]["heal_deferrals"] == 2
    assert got["first"]["deferred_heal_bytes"] == 2000
    assert got["then"]["heal_floor_grants"] == 2


def resync_throttled(pkg):
    c = pkg.Client(mode="host", transport="rdma", n_targets=2)
    try:
        assert c.cluster.heal_pacer is c.scrubber
        fd = c.open("/f", create=True)
        c.pwrite(fd, payload(4 * BLOCK, seed=16), 0)
        c.cluster.fail_target(1)
        data = payload(4 * BLOCK, seed=17)
        c.pwrite(fd, data, 0)
        c.cluster.heal_pause_s = 0.0005
        c.cluster.heal_pacer = _FakePacer([], max_deferrals=2)
        moved = c.cluster.recover_target(1)
        assert c.pread(fd, len(data), 0) == data
        s = c.cluster.stats
        return {"moved": moved, "deferrals": s.heal_deferrals,
                "bytes": s.deferred_heal_bytes,
                "floor": s.heal_floor_grants}
    finally:
        c.close()


def test_resync_heals_through_the_throttle():
    got = same(resync_throttled)
    assert got["moved"] >= 1 and got["deferrals"] >= 2
    assert got["bytes"] > 0 and got["floor"] >= 1


# ---------------------------------------------------------------------------
# distributed/fault.py and the counters registry


def stragglers(pkg, seed):
    mon = pkg.fault.StragglerMonitor(window=8, factor=2.0)
    rng = np.random.default_rng(seed)
    slow = int(rng.integers(0, 8))
    for step in range(20):
        for rank in range(8):
            dt = 0.1 + rng.uniform(0, 0.01)
            if rank == slow or (rank == (slow + 3) % 8 and step == 3):
                dt = 0.35 if rank == slow else 1.0
            mon.record(rank, dt)
    em = pkg.fault.ElasticMembership(4)
    events = []
    em.subscribe(lambda asg, size: events.append((dict(asg), size)))
    em.leave("host1")
    em.join("host9")
    em.leave("host0")
    return {"slow": slow, "stragglers": mon.stragglers(),
            "medians": mon.medians(), "events": events,
            "assignment": em.assignment(), "size": em.size}


@pytest.mark.parametrize("seed", [0, 5])
def test_straggler_monitor_and_membership(seed):
    got = same(stragglers, seed)
    assert got["stragglers"] == [got["slow"]]
    assert sorted(got["assignment"].values()) == [0, 1, 2]


def failure_drill(pkg):
    """`FailureInjector` against one object store: kill, rebuild, recover,
    corrupt; reads are served from a clean replica throughout."""
    store = pkg.object_store.ObjectStore(pkg.media.make_nvme_array(4))
    cont = store.create_pool("p").create_container("c", replication=2)
    obj = cont.object(7)
    blobs = {str(i): payload(4096 + 977 * i, seed=i) for i in range(8)}
    for d, blob in blobs.items():
        obj.update(d, "data", 0, blob)
    inj = pkg.fault.FailureInjector(store)
    dev = store.devices[1].name

    def read_all():
        return [obj.fetch(d, "data", 0, len(b)) == b for d, b in blobs.items()]
    inj.kill(dev)
    reads = read_all()
    moved = inj.rebuild(dev)
    inj.recover(dev)
    assert inj.corrupt_block(store.devices[0].name, which=3)
    reads += read_all()
    return {"events": inj.events, "moved": moved, "reads": reads,
            "stats": vars(store.stats).copy()}


def test_failure_injector_drill():
    got = same(failure_drill)
    assert all(got["reads"])


def test_counters_registry_matches_reference():
    def registry(pkg):
        cr = pkg.counters_registry
        cr.validate_registry()
        with pytest.raises(cr.UndeclaredCounterError):
            cr.verify({"transport": {"not_a_counter": 1}})
        with pytest.raises(cr.UndeclaredCounterError):
            cr.verify({"faults": {"recovered": {"no.such_path": 1}}})
        return {"counters": {k: sorted(v) for k, v in cr.COUNTERS.items()},
                "paths": sorted(cr.RECOVERY_PATHS),
                "kinds": sorted(cr.FAULT_KINDS)}
    same(registry)
