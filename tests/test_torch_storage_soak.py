"""The seeded crash-recovery soak (`tests/test_fault_storage.py`
`test_seeded_crash_recovery_soak`) through both packages.

The same `SOAK_SCHEDULE`, seeds 1234 (injector) and 99 (ops) and armed
singles drive the reference's `repro.core` client and the port's
`repro_torch.core` client (`device="cpu"`): mixed striped writes, reads and
vectored pairs while the injector fires at every layer boundary, a target
failed with its map push dropped and recovered 16 ops later, and a final
sweep. Each run holds the reference test's own assertions (bit-exact
against a shadow, every recovery class fired, no leak).

Where the op stream is sequential (`io_depth == 1`) the two packages must
also agree exactly: every op's result, `inj.counters()`, the `ec` and
`cluster` counters and what each target holds at the end (`placed`).
These runs take the router's fan-out inline (`serial_router`): with its
pool, which stripe cell or target run reaches a fault rule's m-th match
first is a race in the reference itself (its `ec.cell_retry` and
injected counts, and `cluster.placement_cache_hits`, move by one between
two of its own runs).

Thread timing decides the async leg (`io_depth == 8`: which in-flight
fragment draws which injected fault), so there the port is held to the
reference test's assertions only
(`test_async_soak_holds_the_reference_assertions`).
"""
import hashlib
from collections import Counter

import numpy as np
import pytest

from _torch_parity import (DOMAINS4, DOMAINS8, PORT, REF, flat, image,
                           no_leaks, placed, serial_router,
                           storage_env)  # noqa: F401
from repro.core.dfs import BLOCK


def soak_schedule(pkg):
    Fault = pkg.faults.Fault
    return [
        ("transport.write_sg", Fault("error"), lambda m: m % 23 == 5),
        ("transport.read_sg", Fault("error"), lambda m: m % 17 == 4),
        ("transport.read_sg", Fault("partial"), lambda m: m % 31 == 9),
        ("transport.place_sg", Fault("partial"), lambda m: m % 19 == 6),
        ("media.write", Fault("error",
                              exc=lambda: IOError("injected media write")),
         lambda m: m % 97 == 13),
        ("media.read", Fault("error",
                             exc=lambda: IOError("injected media read")),
         lambda m: m % 61 == 9),
    ]


def _digest(b):
    return hashlib.sha256(b).hexdigest()


def soak(pkg, transport, redundancy, io_depth, inline_encryption=False,
         serial=False):
    """The reference soak's body with its assertions; returns what a
    sequential run must reproduce exactly. `serial` runs the router's
    fan-out inline (`serial_router`)."""
    Fault = pkg.faults.Fault
    inj = pkg.faults.FaultInjector(schedule=soak_schedule(pkg), seed=1234)
    ec = redundancy in ("ec", "ec8")
    wide = redundancy == "ec8"
    c = pkg.Client(mode="host", transport=transport,
                   n_targets=(8 if wide else 4) if ec else 2,
                   n_devices=4, replication=3, write_quorum=2,
                   fault_injector=inj, io_depth=io_depth,
                   inline_encryption=inline_encryption,
                   ec=((4, 2) if wide else (2, 1)) if ec else None,
                   domains=(DOMAINS8 if wide else DOMAINS4) if ec else None)
    if serial:
        serial_router(c)
    results = []
    try:
        inj.arm("engine.crash", Fault("crash"), 4)
        if transport == "rdma":
            inj.arm("cap.expire", Fault("expire"), 3)
        inj.arm("control.rpc.get_pool_map", Fault("drop"), 1)
        fd = c.open("/soak", create=True)
        span = 16 * BLOCK
        shadow = bytearray(span)
        results.append(c.pwrite(fd, bytes(shadow), 0))
        vic = 1
        if wide:
            k_, _p, _cs = c.io._ec
            oid0 = sorted({o for cont in c.ccontainer._per_target.values()
                           for o in cont._objects})[0]
            homes = Counter(tid for b in range(span // BLOCK)
                            for tid in c.io._ec_order(oid0, b)[:k_])
            vic = homes.most_common(1)[0][0]
        results.append(vic)
        rng = np.random.default_rng(99)
        for i in range(240):
            if i == 80:
                inj.arm("map.push", Fault("drop"), 1)
                c.cluster.fail_target(vic)
            elif i == 96:
                results.append(c.cluster.recover_target(vic))
            in_outage = 80 <= i < 96
            off = int(rng.integers(0, span - 1))
            ln = int(rng.integers(1, min(int(2.5 * BLOCK), span - off) + 1))
            kind = int(rng.integers(0, 4))
            if in_outage and kind == 2 and not ec:
                kind = 0
            if kind <= 1:
                data = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
                results.append(c.pwrite(fd, data, off))
                shadow[off:off + ln] = data
            elif kind == 2:
                got = c.pread(fd, ln, off)
                assert got == bytes(shadow[off:off + ln]), f"op {i}"
                results.append(_digest(got))
            else:
                cut = max(1, ln // 3)
                data = bytes(rng.integers(0, 256, ln, dtype=np.uint8))
                results.append(c.pwritev(fd, [data[:cut], data[cut:]], off))
                shadow[off:off + ln] = data
                parts = c.preadv(fd, [cut, ln - cut], off)
                assert b"".join(parts) == data, f"op {i}"
                results.append([_digest(p) for p in parts])
        assert c.pread(fd, span, 0) == bytes(shadow)
        f = inj.counters()
        expected = ["transport.write_sg", "media.write", "media.read",
                    "engine.crash", "control.rpc.get_pool_map", "map.push"]
        expected += (["transport.place_sg", "cap.expire"]
                     if transport == "rdma" else ["transport.read_sg"])
        for op in expected:
            assert f["injected"].get(op, 0) >= 1, f"{op} never fired"
        rec = f["recovered"]
        assert rec.get("transport.retry", 0) >= 1
        assert rec.get("control.rpc_retry", 0) >= 1
        if transport == "rdma":
            assert rec.get("cap.renewed", 0) >= 1
        if not ec:
            assert rec.get("dispatch.retry", 0) >= 1
            assert c.io.target_retries >= 1
            assert c.io.retried_runs >= 1
        counters = c.io.data_path_counters()
        assert counters["faults"]["total_injected"] == f["total_injected"]
        assert counters["cluster"]["retried_runs"] == c.io.retried_runs
        if ec:
            assert counters["ec"]["degraded_reads"] >= 1
            assert counters["ec"]["reconstructions"] >= 1
            assert counters["ec"]["rebuilt_cells"] >= 1
            assert rec.get("ec.degraded_read", 0) >= 1
            assert rec.get("ec.rebuilt", 0) >= 1
            if wide:
                assert counters["ec"]["delta_writes"] >= 1
                assert counters["ec"]["delta_bytes_saved"] >= 1
                assert counters["ec"]["delta_fallbacks"] >= 1
                assert rec.get("ec.delta_fallback", 0) >= 1
            c.cluster.resync()
            dirty = pkg.object_store.EC_DIRTY_AKEY
            for cont in c.ccontainer._per_target.values():
                for _oid, obj in list(cont._objects.items()):
                    assert not obj.dkeys(dirty)
        if io_depth > 1:
            recovered_before = inj.counters()["total_recovered"]
            assert c.io.cq.counters()["inflight_peak"] <= 1
            window = []
            for _ in range(96):
                off = int(rng.integers(0, span - 1))
                ln = int(rng.integers(1, min(int(2.5 * BLOCK),
                                             span - off) + 1))
                cut = max(1, ln // 3)
                window.append((c.submit_preadv(fd, [cut, ln - cut], off),
                               off, ln))
                if len(window) >= io_depth:
                    h, o, n = window.pop(0)
                    assert b"".join(h.wait()) == bytes(shadow[o:o + n])
            for h, o, n in window:
                assert b"".join(h.wait()) == bytes(shadow[o:o + n])
            assert inj.counters()["total_recovered"] > recovered_before
            cq = c.io.cq.counters()
            assert cq["inflight_peak"] >= io_depth // 2
            assert cq["completed"] == cq["submitted"] - cq["cancelled"]
        no_leaks(c)
        return {"results": results,
                "counters": flat({"injector": inj.counters(),
                                  "ec": counters.get("ec") or {},
                                  "cluster": counters["cluster"]}),
                "placed": placed(image(c))}
    finally:
        c.close()


SEQUENTIAL = [("rdma", "rep", False), ("tcp", "rep", False),
              ("rdma", "ec", False), ("rdma", "ec8", False),
              ("rdma", "ec8", True)]


@pytest.mark.parametrize(
    "transport,redundancy,enc", SEQUENTIAL,
    ids=[f"{t}-{r}-1{'-enc' if e else ''}" for t, r, e in SEQUENTIAL])
def test_sequential_soak_matches_reference(transport, redundancy, enc):
    want = soak(REF, transport, redundancy, 1, enc, serial=True)
    got = soak(PORT, transport, redundancy, 1, enc, serial=True)
    assert got["results"] == want["results"]
    differ = {k: (got["counters"].get(k), want["counters"].get(k))
              for k in got["counters"].keys() | want["counters"].keys()
              if got["counters"].get(k) != want["counters"].get(k)}
    assert not differ, f"counters differ (port, reference): {differ}"
    assert got["placed"] == want["placed"], "targets hold other blocks"


def test_async_soak_holds_the_reference_assertions():
    """`("rdma", "rep", 8)`: the async leg's fault draws depend on thread
    timing, so only the reference test's assertions hold."""
    soak(PORT, "rdma", "rep", 8)
