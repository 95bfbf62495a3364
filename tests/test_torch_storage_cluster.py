"""The cluster against the reference, in `core/object_store.py`:
`jump_hash` and `placement_order` at 2-8 targets with and without fault
domains, `PoolMap` versions and pushes, `StorageCluster`'s stale-map
refresh and retry, target add with its rebalance, `resync` and
`recover_target`, and `MediaScrubber`'s parity scrub; and the erasure
coded container over it: striping, delta writes, degraded reads,
marker-driven rebuild, a torn stripe found and re-healed, placement
repair on add (reference: `tests/test_cluster.py`, `tests/test_erasure.py`,
the placement tests of `tests/test_fault_storage.py`).

Each scenario is replayed through `repro.core` and `repro_torch.core`
(`device="cpu"`); `same` holds equal every placement, map description,
byte read, counter, which cells each target holds and what each target
stores (`placed`). Striped clients run the router's fan-out inline
(`serial_router`), so fault and retry counts follow the op order.

Thread timing decides these outcomes, so the port keeps the reference
test's assertions only: a hedged read racing a slow replica, and a
post-ack replica failure re-replicated across targets
(`test_hedged_reads_and_cross_target_rereplication`).
"""
import threading
import time

import numpy as np
import pytest

from _torch_parity import (DOMAINS8, PORT, REF, counters, image, no_leaks,
                           payload, placed, same, serial_router,
                           storage_env)  # noqa: F401
from repro.core.dfs import AKEY, BLOCK


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def placements(pkg):
    os_ = pkg.object_store
    out = {"jump": [os_.jump_hash(k * 0x9E3779B97F4A7C15, n)
                    for n in (1, 2, 3, 7, 8) for k in range(200)]}
    doms = {2: ("r0", "r1"), 3: ("r0", "r0", "r1"),
            4: ("r0", "r0", "r1", "r1"), 5: ("a", "b", "a", "b", "c"),
            6: ("a", "a", "b", "b", "c", "c"), 7: ("a", "b", "c") * 2 + ("d",),
            8: tuple(DOMAINS8)}
    for n in range(2, 9):
        out[n] = [(os_.placement_order(n, oid, str(b)),
                   os_.placement_order(n, oid, str(b), doms[n]),
                   os_.placement_order(n, oid, str(b), (None,) * n))
                  for oid in (1, 77, 100, 4097) for b in range(24)]
    cluster = pkg.Cluster(n_targets=2)
    try:
        for t, d in zip(cluster.pool_map.targets, ("r0", "r0")):
            t.domain = d
        cluster.add_target(rebalance=False, domain="r1")
        out["describe"] = cluster.pool_map.describe()
        out["place"] = [cluster.pool_map.place(oid, str(b))
                        for oid in range(4) for b in range(8)]
    finally:
        cluster.close()
    return out


def test_placement_matches_reference_at_2_to_8_targets():
    got = same(placements)
    for n in range(2, 9):
        for flat, dom, nones in got[n]:
            assert sorted(flat) == list(range(n)) and dom[0] == flat[0]
            assert nones == flat


def map_lifecycle(pkg, case):
    """A map push lost or delivered around a failed target, a runtime
    target add (rebalance, lazy session), the get_pool_map RPC, the
    router's placement memo, and recovery moving outage writes home."""
    c = serial_router(pkg.Client(mode="host", transport="rdma",
                                 n_targets=2, replication=2))
    out = {}
    try:
        fd = c.open("/f", create=True)
        data = payload(6 * BLOCK, seed=3)
        c.pwrite(fd, data, 0)
        out["map0"] = c.control.rpc("get_pool_map",
                                    session_id=c.session_id)["version"]
        if case in ("lost_push", "push"):
            c.cluster.fail_target(1, notify=case == "push")
            data2 = payload(4 * BLOCK, seed=4)
            c.pwrite(fd, data2, 0)
            out["read"] = c.pread(fd, len(data2), 0)
            r = c.control.rpc("get_pool_map", session_id=c.session_id)
            out["map"] = sorted((t["target_id"], t["up"])
                                for t in r["targets"])
            out["redundancy"] = r["redundancy"]
            out["moved"] = c.cluster.recover_target(1)
            out["after"] = c.pread(fd, 6 * BLOCK, 0)
        else:
            out["tid"] = c.add_target(domain="rackZ")
            out["old"] = c.pread(fd, len(data), 0)
            fd2 = c.open("/new", create=True)
            new = payload(8 * BLOCK, seed=8)
            c.pwrite(fd2, new, 0)
            out["new"] = c.pread(fd2, len(new), 0)
            out["sessions"] = sorted(c.io.sessions)
            out["routes"] = sorted(c.io._place_cache.values())
            out["domains"] = c.io._domains
        out["stats"] = (c.io.target_retries, c.io.map_refreshes,
                        c.io.map_invalidations, c.io.placement_cache_hits)
        c.close_fd(fd)
        c.truncate("/f", BLOCK)
        fd = c.open("/f")
        out["truncated"] = c.pread(fd, 2 * BLOCK, 0)
        out["counters"] = counters(c)
        out["placed"] = placed(image(c))
        c.unlink("/f")
        out["used"] = [sum(d.used_bytes() for d in t.store.devices)
                       for t in c.cluster.targets]
        no_leaks(c)
        return out
    finally:
        c.close()


@pytest.mark.parametrize("case", ["lost_push", "push", "add"])
def test_pool_map_lifecycle_matches_reference(case):
    got = same(map_lifecycle, case)
    retries, refreshes, invalidations, hits = got["stats"]
    if case == "lost_push":
        assert retries == 1
    if case == "push":
        assert retries == 0 and invalidations >= 1
    if case == "add":
        assert got["tid"] == 2 and 2 in got["sessions"]
        assert got["domains"][2] == "rackZ"
    else:
        assert got["map"] == [(0, True), (1, False)]
        assert got["moved"] >= 1
    assert got["truncated"][BLOCK:] == bytes(BLOCK)


def test_add_target_refused_on_unrouted_client():
    def case(pkg):
        c = pkg.Client(mode="host", transport="rdma")
        try:
            fd = c.open("/f", create=True)
            data = payload(2 * BLOCK, seed=42)
            c.pwrite(fd, data, 0)
            with pytest.raises(RuntimeError, match="routed client"):
                c.add_target()
            return c.pread(fd, len(data), 0) == data
        finally:
            c.close()
    assert same(case)


def _dirty(c, n_cells):
    out = {}
    for cont in c.ccontainer._per_target.values():
        for oid, obj in list(cont._objects.items()):
            for dk in obj.dkeys(EC_DIRTY):
                marks = obj.fetch(dk, EC_DIRTY, 0, n_cells)
                cells = sorted(i for i, b in enumerate(marks) if b)
                if cells:
                    out.setdefault(f"{oid}/{dk}", set()).update(cells)
    return out


EC_DIRTY = REF.object_store.EC_DIRTY_AKEY
assert EC_DIRTY == PORT.object_store.EC_DIRTY_AKEY


def _cells(c):
    _k, _p, cs = c.io._ec
    out = set()
    for tid, cont in c.ccontainer._per_target.items():
        for oid, obj in list(cont._objects.items()):
            with obj._lock:
                items = [(dk, list(exts)) for (dk, ak), exts
                         in obj._extents.items() if ak == AKEY]
            for dk, exts in items:
                out.update((tid, oid, dk, e.offset // cs) for e in exts)
    return sorted(out)


GEOMETRIES = {"ec21@4": ((2, 1), 4, ["a", "a", "b", "b"], False),
              "ec42@8": ((4, 2), 8, DOMAINS8, False),
              "ec42@8-enc": ((4, 2), 8, DOMAINS8, True),
              "ec83@12": ((8, 3), 12, ["a", "b", "c", "d"] * 3, False)}


def erasure(pkg, name):
    """Stripe, patch a partial cell (delta), fail p of stripe 0's homes,
    read degraded, write into the outage, recover (rebuild exactly the
    marked cells), tear a parity row and let the scrub and resync heal
    it, then add a target (placement repair)."""
    ec, n, doms, enc = GEOMETRIES[name]
    c = serial_router(pkg.Client(mode="host", transport="rdma", n_targets=n,
                                 ec=ec, domains=doms,
                                 inline_encryption=enc))
    out = {}
    try:
        k, p, cs = c.io._ec
        fd = c.open("/f", create=True)
        shadow = bytearray(payload(2 * BLOCK + 12345, 71))
        c.pwrite(fd, bytes(shadow), 0)
        patch = payload(cs + 77, 72)
        c.pwrite(fd, patch, cs // 2)
        shadow[cs // 2:cs // 2 + len(patch)] = patch
        out["cells"] = _cells(c)
        oid = c.dfs.stat("/f")["oid"]
        order = c.io._ec_order(oid, 0)
        for tid in order[:p]:
            c.cluster.fail_target(tid)
        out["degraded"] = c.pread(fd, len(shadow), 0)
        fresh = payload(BLOCK, 73)
        c.pwrite(fd, fresh, 0)
        shadow[:len(fresh)] = fresh
        out["dirty"] = _dirty(c, k + p)
        out["rebuilt"] = [c.cluster.recover_target(t) for t in order[:p]]
        out["clean"] = _dirty(c, k + p)
        out["healed"] = c.pread(fd, len(shadow), 0)
        c.io._ec_drain()
        out["scrub0"] = c.scrubber.scrub_once()
        c.io.sessions[order[k]].update_cell(oid, 0, k * cs,
                                            np.zeros(cs, np.uint8))
        out["scrub1"] = c.scrubber.scrub_once()
        out["torn"] = _dirty(c, k + p)
        c.cluster.resync()
        out["scrub2"] = c.scrubber.scrub_parity(64 * BLOCK)
        c.cluster.fail_target(order[0])
        out["through_parity"] = c.pread(fd, len(shadow), 0)
        c.cluster.recover_target(order[0])
        if name == "ec21@4":
            out["tid"] = c.add_target()
            out["repaired"] = _cells(c)
            out["after_add"] = c.pread(fd, len(shadow), 0)
        assert out["healed"] == bytes(shadow)
        out["counters"] = counters(c)
        out["placed"] = placed(image(c))
        out["media"] = {}
        no_leaks(c)
        return out
    finally:
        c.close()


@pytest.mark.parametrize("name", list(GEOMETRIES))
def test_erasure_coded_cluster_matches_reference(name):
    got = same(erasure, name)
    ec, n, doms, _enc = GEOMETRIES[name]
    k, p = ec
    assert got["dirty"] and not got["clean"]
    assert got["scrub0"]["parity_mismatches"] == 0
    assert got["scrub1"]["parity_mismatches"] >= 1
    assert any(k <= i < k + p for cells in got["torn"].values()
               for i in cells)
    assert got["scrub2"]["parity_mismatches"] == 0
    assert got["counters"]["ec.delta_writes"] >= 1
    assert got["counters"]["ec.reconstructions"] >= p
    if "repaired" in got:
        homes = {(o, d, cell): t for t, o, d, cell in got["repaired"]}
        assert len(homes) == len(got["repaired"])


def test_erasure_rejects_bad_geometry():
    def case(pkg):
        out = []
        for n, ec in ((2, (2, 1)), (4, (3, 1)), (5, (4, 2)), (10, (8, 3))):
            with pytest.raises(ValueError) as ei:
                pkg.Client(mode="host", transport="rdma", n_targets=n,
                           ec=ec)
            out.append(str(ei.value))
        return out
    same(case)


def hedge_config_and_checksum_offload(pkg):
    c = pkg.Client(mode="host", transport="rdma", n_targets=2,
                   hedge_timeout_s=0.05)
    try:
        out = [[t.store.hedge_timeout_s for t in c.cluster.targets]]
        c.configure_hedged_reads(None)
        out.append([t.store.hedge_timeout_s for t in c.cluster.targets])
    finally:
        c.close()
    for repl in (3, 2):
        store = pkg.object_store.ObjectStore(pkg.media.make_nvme_array(
            repl if repl == 3 else 4))
        try:
            cont = store.create_pool("p").create_container(
                "c", replication=repl)
            obj = cont.object(1)
            data = payload(1 << 16, seed=15)
            obj.update("0", AKEY, 0, data)
            ext = obj._extents[("0", AKEY)][0]
            name, key = next(iter(ext.block_keys.items()))
            store.device(name).writeback()
            store.device(name)._blocks[key] = bytes(len(data))
            out.append([obj.fetch("0", AKEY, 0, len(data)) == data,
                        store.stats.checksum_offloads,
                        store.stats.checksum_bytes >= len(data)])
        finally:
            store.close()
    return out


def test_hedge_config_and_checksum_offload_match_reference():
    got = same(hedge_config_and_checksum_offload)
    assert got[0] == [0.05, 0.05] and got[1] == [None, None]
    assert got[2][:2] == [True, 1] and got[3][:2] == [True, 0]


def test_hedged_reads_and_cross_target_rereplication():
    """Timing: which replica answers first, and when a straggler dies."""
    store = PORT.object_store.ObjectStore(PORT.media.make_nvme_array(4))
    try:
        cont = store.create_pool("p").create_container("c", replication=2)
        obj = cont.object(1)
        data = payload(1 << 16, seed=13)
        obj.update("0", AKEY, 0, data)
        primary = next(iter(obj._extents[("0", AKEY)][0].block_keys))
        store.device(primary).read_delay_s = 0.2
        t0 = time.monotonic()
        assert obj.fetch("0", AKEY, 0, len(data)) == data
        assert time.monotonic() - t0 >= 0.2
        assert store.stats.hedges_issued == 0
        store.hedge_timeout_s = 0.02
        t0 = time.monotonic()
        assert obj.fetch("0", AKEY, 0, len(data)) == data
        assert time.monotonic() - t0 < 0.15
        assert store.stats.hedges_issued == 1 and store.stats.hedges_won == 1
        store.device(primary).read_delay_s = 0.0
    finally:
        store.close()
    cluster = PORT.Cluster(n_targets=2, n_devices=2)
    try:
        cc = cluster.create_pool("p").create_container(
            "c", replication=2, verified_cache=True, write_quorum=1)
        obj = cc.target(0).object(1)
        victim = [d for d in cc.target(0).placement(1, "0") if d.alive][1]
        orig = victim.write
        gate = threading.Event()

        def slow_failing_write(key, data, lease=None, pre_pinned=False):
            gate.wait(5.0)
            raise IOError("injected straggler media failure")
        victim.write = slow_failing_write
        data = payload(1 << 16, seed=9)
        obj.update("0", AKEY, 0, data)
        gate.set()
        assert _wait(lambda: cluster.stats.cross_target_rereplications >= 1)
        victim.write = orig
        assert victim.name not in obj._extents[("0", AKEY)][0].block_keys
        peer = cc.target(1).peek_object(1)
        assert peer is not None
        assert peer.fetch("0", AKEY, 0, len(data)) == data
    finally:
        cluster.close()


def device_lookup(pkg):
    """`StorageCluster.device(name)` finds a storage device fleet-wide; the
    scrubber and `FailureInjector` drive a cluster through it."""
    c = pkg.Client(mode="host", transport="rdma", n_targets=2)
    try:
        fd = c.open("/f", create=True)
        data = payload(4 * BLOCK, seed=5)
        c.pwrite(fd, data, 0)
        c.pread(fd, len(data), 0)
        names = [d.name for d in c.cluster.devices]
        found = [c.cluster.device(n).name for n in names]
        inj = pkg.fault.FailureInjector(c.cluster)
        c.cluster.device(names[1]).fail()
        reads = [c.pread(fd, len(data), 0) == data]
        inj.recover(names[1])
        scrub = c.scrubber.scrub_once()
        reads.append(c.pread(fd, len(data), 0) == data)
        return {"found": found == names, "missing": c.cluster.device("x"),
                "reads": reads, "events": inj.events, "scrub": scrub}
    finally:
        c.close()


def test_cluster_device_lookup_matches_reference():
    got = same(device_lookup)
    assert got["found"] and got["missing"] is None
    assert got["reads"] == [True, True]
    assert got["scrub"]["scanned_bytes"] > 0
