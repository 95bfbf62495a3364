"""The control plane against the reference: `core/control_plane.py`
(`ControlPlane`: compound RPCs, sessions, rkey grant/renew/revoke),
`core/metadata_cache.py` (`MetadataCache`: leases under an injected clock)
and `core/dfs.py` (`DFSClient`: create, unlink, truncate, stat, flush and
the cross-session recalls), with the round-trip budgets: a cycle takes at
most 2 RPCs, a warm open 0, and control bytes stay under 1% of data bytes
(reference: `tests/test_control_plane.py`, `tests/test_core_storage.py`).

Each scenario is replayed through `repro.core` and `repro_torch.core`
(`device="cpu"`); `same` holds equal every RPC reply (session ids and
capability tokens, which are random, masked), lease decisions, sizes,
bytes read, capacity used and the RPC counts.

Thread timing decides these outcomes, so they keep the reference test's
assertions only: connect/disconnect stress from 8 threads
(`test_concurrent_connect_disconnect_stress`) and the renewals a wall
clock drives (`test_renewal_on_the_wall_clock`).
"""
import threading
import time

import pytest

from _torch_parity import (PORT, REF, counters, no_leaks, payload, same,
                           storage_env)  # noqa: F401
from repro.core.dfs import BLOCK

BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])
RANDOM_IDS = {"session_id", "rkey", "token", "mount_id"}


def masked(x):
    """An RPC reply with its random ids replaced by their type."""
    if isinstance(x, dict):
        return {k: (type(v).__name__ if k in RANDOM_IDS else masked(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [masked(v) for v in x]
    return x


def make_cp(pkg, meta_lease_s=30.0, tenants=None):
    store = pkg.object_store.ObjectStore(pkg.media.make_nvme_array(2))
    reg = pkg.data_plane.MemoryRegistry("srv")
    cp = pkg.control_plane.ControlPlane(store, reg, tenants or {"t": "s"},
                                        meta_lease_s=meta_lease_s)
    cp.bind_dfs(pkg.dfs.DFSMeta(store))
    return cp, reg


def compounds(pkg):
    cp, reg = make_cp(pkg)
    sid = cp.rpc("connect", tenant="t", secret="s")["session_id"]
    out = [cp.rpc("compound", session_id=sid, ops=[
        {"method": "create", "args": {"path": "/a"}},
        {"method": "lookup", "args": {"path": "/missing"}},
        {"method": "create", "args": {"path": "/b"}}])]
    out += [cp.rpc("lookup", session_id=sid, path=p)["ok"]
            for p in ("/a", "/b")]
    mr = reg.register(1024, "t")
    before = cp.rpc_count
    r = cp.rpc("compound", ops=[
        {"method": "connect", "args": {"tenant": "t", "secret": "s"}},
        {"method": "mount", "args": {"pool": "p", "container": "c"}},
        {"method": "grant_rkey", "args": {"region_id": mr.region_id}}])
    out += [r, cp.rpc_count - before, cp.compound_ops,
            r["session_id"] == r["results"][0]["session_id"]]
    out.append(cp.rpc("compound", ops=[
        {"method": "compound", "args": {"ops": []}}]))
    out.append(cp.rpc("compound", ops=[{"method": "bogus", "args": {}}]))
    out.append(cp.rpc("readdir", session_id=sid, path="/"))
    out.append(cp.rpc("connect", tenant="t", secret="wrong"))
    return masked(out)


def test_compound_rpcs_match_reference():
    got = same(compounds)
    assert got[0]["completed"] == 1 and len(got[0]["results"]) == 2
    assert got[1:3] == [True, False]
    assert got[4] == 1 and got[6] is True


def leases(pkg):
    """Meta leases and rkey renewal under an injected clock, and a denied
    cross-tenant renewal."""
    cp, reg = make_cp(pkg, meta_lease_s=10.0)
    sid = cp.rpc("connect", tenant="t", secret="s")["session_id"]
    now = [0.0]
    MC = pkg.metadata_cache.MetadataCache
    cache = MC(cp, sid, skew_margin=0.25, clock=lambda: now[0])
    cache.put_meta("/x", {"oid": 5, "size": 0}, ttl_s=10.0)
    seen = []
    for t in (0.0, 7.4, 7.6):
        now[0] = t
        seen.append(cache.get_meta("/x"))
    mr = reg.register(256, "t")
    token = cp.rpc("grant_rkey", session_id=sid, region_id=mr.region_id,
                   ttl_s=0.05)["rkey"]
    now[0] = 0.0
    cache2 = MC(cp, sid, skew_margin=0.25, clock=lambda: now[0])
    cache2.put_rkey(token, ttl_s=0.05)
    granted = reg._rkeys[token].expires_at
    now[0] = 0.04
    steps = [cache2.rkey_fresh(token), cache2.renew_due(),
             cache2.rkey_fresh(token),
             reg._rkeys[token].expires_at > granted]
    cp.rpc("revoke_rkey", session_id=sid, rkey=token)
    now[0] = 0.08
    steps += [cache2.renew_due(), cache2.rkey_fresh(token)]
    cp2, reg2 = make_cp(pkg, tenants={"a": "sa", "b": "sb"})
    sa = cp2.rpc("connect", tenant="a", secret="sa")["session_id"]
    sb = cp2.rpc("connect", tenant="b", secret="sb")["session_id"]
    mr2 = reg2.register(64, "a")
    tok = cp2.rpc("grant_rkey", session_id=sa, region_id=mr2.region_id,
                  ttl_s=1.0)["rkey"]
    expires = reg2._rkeys[tok].expires_at
    denied = cp2.rpc("renew_rkey", session_id=sb, rkey=tok, ttl_s=9999.0)
    return {"meta": seen, "rkey": steps, "stats": dict(vars(cache.stats)),
            "stats2": dict(vars(cache2.stats)), "denied": masked(denied),
            "untouched": reg2._rkeys[tok].expires_at == expires}


def test_leases_under_an_injected_clock_match_reference():
    got = same(leases)
    assert got["meta"][1] is not None and got["meta"][2] is None
    assert got["rkey"] == [False, 1, True, True, 0, False]
    assert not got["denied"]["ok"] and got["untouched"]


def _used(c):
    for d in c.devices:
        d.writeback()
    return sum(d.used_bytes() for d in c.devices)


def namespace(pkg, mode):
    """create, write, stat, truncate (shrink with punch, on unflushed
    delegated writes, grow), unlink with reclaim, a write after unlink,
    a flush around a foreign unlink, and a second session's recalls."""
    c = pkg.Client(mode=mode, transport="rdma")
    out = []
    try:
        base = _used(c)
        fd = c.open("/t", create=True)
        data = bytes(range(256)) * ((3 * BLOCK) // 256)
        c.pwrite(fd, data, 0)
        c.fsync(fd)
        out.append(_used(c) - base)
        half = BLOCK + BLOCK // 2
        out += [c.truncate("/t", half), c.stat("/t"), _used(c) - base]
        c.pwrite(fd, b"Q", 3 * BLOCK - 1)
        out.append(c.pread(fd, 3 * BLOCK, 0))
        c.close_fd(fd)
        fd = c.open("/lag", create=True)
        c.pwrite(fd, b"z" * (2 * BLOCK + 5), 0)
        c.truncate("/lag", BLOCK)
        out += [c.stat("/lag"), c.pread(fd, BLOCK + 5, 0), _used(c)]
        c.truncate("/lag", 3 * BLOCK + 1000)
        out += [c.stat("/lag"), c.pread(fd, 4096, 3 * BLOCK)]
        c.close_fd(fd)
        c.unlink("/lag")
        c.unlink("/t")
        out.append(_used(c) - base)
        with pytest.raises(pkg.dfs.DFSError):
            c.dfs.open("/t")
        fd = c.open("/orphan", create=True)
        c.pwrite(fd, b"d" * 4096, 0)
        c.unlink("/orphan")
        try:                             # StorageError, or OSError via dpu
            c.pwrite(fd, b"late" * 1024, 0)
            out.append("wrote")
        except (pkg.object_store.StorageError, OSError) as e:
            out.append(type(e).__name__)
        out.append(_used(c) - base)
        c.close_fd(fd)
        fd1, fd2 = c.open("/f1", create=True), c.open("/f2", create=True)
        c.pwrite(fd1, b"a" * 100, 0)
        c.pwrite(fd2, b"b" * 200, 0)
        sid_b = c.control.rpc("connect", tenant="default",
                              secret="secret")["session_id"]
        out.append(c.control.rpc("unlink", session_id=sid_b,
                                 path="/f1")["ok"])
        out += [c.dfs.flush_meta(), c.stat("/f2")]
        cache_b = pkg.metadata_cache.MetadataCache(c.control, sid_b)
        dfs_b = pkg.dfs.DFSClient(c.control, c.io, sid_b, cache=cache_b)
        fd = c.open("/shared", create=True)
        c.pwrite(fd, b"a" * 100, 0)
        c.close_fd(fd)
        out.append(c.stat("/shared"))
        inv = c.cache.stats.invalidations
        dfs_b.truncate("/shared", 10)
        out += [c.cache.stats.invalidations - inv, c.stat("/shared")]
        b_inv = cache_b.stats.invalidations
        fd = c.open("/shared")
        c.pwrite(fd, b"b" * 500, 0)
        c.close_fd(fd)
        out += [cache_b.stats.invalidations > b_inv,
                dfs_b.stat("/shared")]
        inv = c.cache.stats.invalidations
        fd_b = dfs_b.open("/shared", create=True)    # create-as-open no-op
        n = c.control.rpc_count
        fd = c.open("/shared")
        out += [c.cache.stats.invalidations - inv, c.control.rpc_count - n]
        dfs_b.close(fd_b)
        c.close_fd(fd)
        out += [c.control.rpc_count, dict(vars(c.cache.stats)),
                dict(vars(cache_b.stats))]
        no_leaks(c)
        return out
    finally:
        c.close()


@pytest.mark.parametrize("mode", ["host", "dpu"])
def test_namespace_ops_match_reference(mode):
    out = same(namespace, mode)
    half = BLOCK + BLOCK // 2
    assert out[0] == 3 * BLOCK * 2 and out[3] == half * 2
    assert set(out[2]) == {"oid", "is_dir", "size", "path"}
    assert set(out[1]) == {"oid", "is_dir", "size"}


def budgets(pkg, mode):
    """open, 3 writes, close; a warm open and close; then 8 MiB written
    and read back in 1 MiB ops."""
    c = pkg.Client(mode=mode, transport="rdma")
    try:
        n0 = c.control.rpc_count
        fd = c.open("/cyc", create=True)
        for i in range(3):
            c.pwrite(fd, b"w" * 4096, i * 4096)
        c.close_fd(fd)
        cycle = c.control.rpc_count - n0
        n1 = c.control.rpc_count
        fd = c.open("/cyc")
        warm = c.control.rpc_count - n1
        c.close_fd(fd)
        warm_close = c.control.rpc_count - n1
        fd = c.open("/ratio", create=True)
        chunk = payload(BLOCK, seed=3)
        for i in range(8):
            c.pwritev(fd, [chunk], i * BLOCK)
        reads = [c.pread(fd, BLOCK, i * BLOCK) == chunk for i in range(8)]
        c.close_fd(fd)
        ctr = counters(c)
        data_bytes = sum(v for k, v in ctr.items()
                         if k.endswith("transport.bytes_moved"))
        # control.rpc_bytes differs between two clients of one process
        # (see NONDETERMINISTIC), so each package's ratio is held apart
        assert c.control.rpc_bytes < 0.01 * data_bytes
        return {"cycle": cycle, "warm": warm, "warm_close": warm_close,
                "reads": reads, "rpcs": c.control.rpc_count,
                "counters": ctr}
    finally:
        c.close()


@pytest.mark.parametrize("mode", ["host", "dpu"])
def test_round_trip_budgets_match_reference(mode):
    got = same(budgets, mode)
    assert got["cycle"] <= 2 and got["warm"] == got["warm_close"] == 0
    assert all(got["reads"]) and got["rpcs"] <= 6


@BOTH
def test_concurrent_connect_disconnect_stress(pkg):
    """Timing: 8 threads interleave connects, readdirs and disconnects."""
    cp, _ = make_cp(pkg)
    errors = []

    def churn():
        try:
            for _ in range(100):
                r = cp.rpc("connect", tenant="t", secret="s")
                assert r["ok"]
                sid = r["session_id"]
                assert cp.rpc("readdir", session_id=sid, path="/")["ok"]
                assert cp.rpc("disconnect", session_id=sid)["ok"]
        except Exception as e:           # noqa: BLE001 - reported below
            errors.append(e)
    threads = [threading.Thread(target=churn, name=f"arm-churn{i}")
               for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    assert cp._sessions == {}


@BOTH
def test_renewal_on_the_wall_clock(pkg):
    """Timing: leases lapse or renew as the wall clock runs. A legacy
    client's short rkey hard-faults; the lease layer renews it first, on
    the host and on the dpu's housekeeping core."""
    c = pkg.Client(mode="host", transport="rdma", legacy=True,
                   rkey_ttl_s=0.05)
    try:
        fd = c.open("/f", create=True)
        c.pwrite(fd, b"x" * 1024, 0)
        time.sleep(0.1)
        with pytest.raises(pkg.data_plane.AccessError):
            c.pwrite(fd, b"y" * 1024, 0)
    finally:
        c.close()
    for mode in ("host", "dpu"):
        c = pkg.Client(mode=mode, transport="rdma", rkey_ttl_s=0.1,
                       renew_interval_s=0.02)
        try:
            fd = c.open("/f", create=True)
            c.pwrite(fd, b"x" * 1024, 0)
            time.sleep(0.3)
            if mode == "host":
                assert c.cache.stats.rkey_renewals > 0
            else:
                assert c.dpu.housekeeping_runs > 0
            c.pwrite(fd, b"y" * 1024, 0)
            assert c.pread(fd, 1024, 0) == b"y" * 1024
        finally:
            c.close()
