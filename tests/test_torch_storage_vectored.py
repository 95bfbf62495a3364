"""Vectored and direct-splice I/O against the reference: `readv_into`
and the direct splice of `_ServerIO` and `_ClusterRouter`, `pwritev` and
`preadv`, donation in `_StagingRing` (`SlotLease`), quorum writes,
`VerifiedExtentCache` (`object_store.py`) and the keystream cache of
`InlineCrypto` (`smartnic.py`) (reference: `tests/test_direct_read_path.py`,
`tests/test_zero_copy_path.py`).

Each deterministic scenario is replayed through `repro.core` and
`repro_torch.core` (`device="cpu"`); `same` holds equal every byte read
(and, within a package, the direct splice equals the staged path and the
shadow), the staging ring's acquires and donations, the engine's checksum
and cache counters, and the keystream. `InlineCrypto`'s cached keystream
is also held against the port's `stream_cipher` plain version
(`stream_cipher_torch`) and the reference's oracle (`cipher_ref`).

Thread timing decides these outcomes, so the port keeps the reference
test's assertions only: a quorum write returning before its straggler, a
full fan-out waiting for it, a straggler's device dying mid-commit, and a
punch racing a straggler commit (`test_quorum_*`).
"""
import time

import numpy as np
import pytest
import torch

from _torch_parity import (PORT, REF, counters, no_leaks, payload, same,
                           storage_env)  # noqa: F401
from repro.core.dfs import AKEY, BLOCK


def _wait(pred, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def direct_vs_staged(pkg, seed, n_targets):
    """Overlapping writes at awkward offsets, then seeded preadv cuts read
    through the direct splice and, on the same client, the staged path."""
    c = pkg.Client(mode="host", transport="rdma", n_targets=n_targets)
    try:
        fd = c.open("/prop", create=True)
        span = 2 * BLOCK + 4096
        shadow = bytearray(span)
        rng = np.random.default_rng(seed)
        for i in range(12):
            off = int(rng.integers(0, span - 100))
            n = int(rng.integers(1, min(span - off, BLOCK + 999)))
            data = payload(n, seed=100 + i)
            c.pwrite(fd, data, off)
            shadow[off:off + n] = data
        cases = [(BLOCK - 3, 7, [3]), (0, span, [1, BLOCK, BLOCK + 1,
                                                 2 * BLOCK]),
                 (BLOCK + 4090, 10, [5])]
        for _ in range(20):
            off = int(rng.integers(0, span - 2))
            n = int(rng.integers(1, min(span - off, BLOCK + 7)))
            cases.append((off, n, [int(x) for x in rng.integers(
                1, max(2, n), size=int(rng.integers(0, 4)))]))
        reads = []
        for off, n, cuts in cases:
            sizes, prev = [], 0
            for cut in sorted(cuts) + [n]:
                if cut > prev:
                    sizes.append(cut - prev)
                    prev = cut
            direct = c.preadv(fd, sizes, off)
            c.io.direct_reads = False
            try:
                staged = c.preadv(fd, sizes, off)
            finally:
                c.io.direct_reads = True
            assert b"".join(direct) == b"".join(staged) \
                == bytes(shadow[off:off + n])
            reads.append(direct)
        no_leaks(c)
        return {"reads": reads, "counters": counters(c)}
    finally:
        c.close()


@pytest.mark.parametrize("seed,n_targets", [(0, 1), (1, 3)])
def test_direct_splice_equals_staged_and_reference(seed, n_targets):
    same(direct_vs_staged, seed, n_targets)


def staging(pkg, kw):
    """Which reads acquire a staging slot and bounce, with the counters:
    the rdma direct path never does, tcp and the sg path always do."""
    c = pkg.Client(mode="host", **kw)
    try:
        fd = c.open("/z", create=True)
        data = payload(4 * BLOCK + 12345, seed=1)
        c.pwrite(fd, data, 0)
        ring = c.io.ring
        a0 = ring.acquires
        reads = [c.pread(fd, len(data), 0),
                 b"".join(c.preadv(fd, [BLOCK, BLOCK + 45, 300], 7))]
        if kw.get("zero_copy", True) and kw["transport"] == "rdma":
            sink = c.register_region(len(data))
            c.pread_into(fd, len(data), 0, sink, 0)
            reads.append(bytes(sink.buf))
            token = c.io._dst_rkey(sink)
            sink.buf[:] = 7
            c.client_registry.revoke(token)
            with pytest.raises(pkg.data_plane.AccessError):
                c.pread_into(fd, BLOCK, 0, sink, 0)
            reads.append(bytes(sink.buf[:BLOCK]))
            c.io.drop_dst_rkey(sink)
            c.client_registry.deregister(sink)
        for _ in range(10):
            c.pread(fd, 4096, 0)
        return {"reads": reads, "acquires": ring.acquires - a0,
                "keys": len(c.client_registry._rkeys),
                "counters": counters(c)}
    finally:
        c.close()


STAGING = {"rdma": dict(transport="rdma"), "tcp": dict(transport="tcp"),
           "sg": dict(transport="rdma", zero_copy=False)}


@pytest.mark.parametrize("name", list(STAGING))
def test_staging_and_capabilities_match_reference(name):
    got = same(staging, STAGING[name])
    if name == "rdma":
        assert got["acquires"] == 0
        assert got["counters"]["staging.bounce_bytes"] == 0
        assert got["reads"][-1] == b"\x07" * BLOCK      # nothing landed
        assert got["keys"] == 0                # transient grants retired
    else:
        assert got["acquires"] > 0


def donation(pkg):
    """Donated slots stay leased until media writeback, ring pressure
    reclaims, and a SlotLease counts its pins."""
    c = pkg.Client(mode="host", transport="rdma", n_staging_slots=4)
    try:
        fd = c.open("/don", create=True)
        first = payload(2 * BLOCK, seed=1)
        c.pwrite(fd, first, 0)
        ring = c.io.ring
        donated = ring.donated_slots()
        with ring._cv:
            free = sorted(ring._free)
        for dev in c.devices:
            dev.writeback()
        after = ring.donated_slots()
        data = payload(16 * BLOCK, seed=3)
        c.pwrite(fd, data, 2 * BLOCK)
        reads = [c.pread(fd, 2 * BLOCK, 0) == first,
                 c.pread(fd, len(data), 2 * BLOCK) == data]
        no_leaks(c)
        out = {"donated": donated, "free": free, "after": after,
               "reclaims": ring.reclaims, "reads": reads,
               "counters": counters(c)}
    finally:
        c.close()
    ring = pkg.client._StagingRing.__new__(pkg.client._StagingRing)
    returned = []
    ring._return_slot = returned.append
    lease = pkg.client.SlotLease(ring, 3)
    steps = []
    for step in ("pin", "pin", "_op_release", "unpin", "unpin"):
        getattr(lease, step)()
        steps.append((list(returned), lease.active))
    out["lease"] = steps
    return out


def test_donation_and_ring_pressure_match_reference():
    got = same(donation)
    assert len(got["donated"]) == 2 and not set(got["donated"]) & set(
        got["free"])
    assert got["after"] == [] and got["reclaims"] > 0 and all(got["reads"])
    assert got["lease"][-1] == ([3], False) and got["lease"][-2][1]


def vcache(pkg):
    """The verified-extent cache: warm reads skip the checksum, and an
    overwrite, a device's fail/recover and a rebuild each invalidate."""
    os_ = pkg.object_store

    def store_(n=4, aggregate=False):
        store = os_.ObjectStore(pkg.media.make_nvme_array(n))
        cont = store.create_pool("p").create_container(
            "c", replication=2, aggregate=aggregate, verified_cache=True)
        return store, cont
    out = {}
    store, cont = store_()
    obj = cont.object(1)
    obj.update("0", "data", 0, payload(1 << 16))
    for _ in range(4):
        obj.fetch("0", "data", 0, 1 << 16)
    out["warm"] = vars(store.stats).copy()
    store, cont = store_(aggregate=True)
    obj = cont.object(1)
    obj.update("0", "data", 0, b"old" * 100)
    obj.fetch("0", "data", 0, 300)
    old = [(n, k) for e in obj._extents[("0", "data")]
           for n, k in e.block_keys.items()]
    checks = [cont.vcache.check(n, k, store.device(n).generation)
              for n, k in old]
    obj.update("0", "data", 0, b"new" * 100)
    checks += [cont.vcache.check(n, k, store.device(n).generation)
               for n, k in old]
    out["overwrite"] = [checks, obj.fetch("0", "data", 0, 300)]
    store, cont = store_(n=2)
    obj = cont.object(1)
    obj.update("0", "data", 0, payload(4096, seed=1))
    obj.fetch("0", "data", 0, 4096)
    name, key = next(iter(obj._extents[("0", "data")][0].block_keys.items()))
    dev = store.device(name)
    before = cont.vcache.check(name, key, dev.generation)
    dev.fail()
    dev.recover()
    out["fail_recover"] = [before, cont.vcache.check(name, key,
                                                     dev.generation),
                           obj.fetch("0", "data", 0, 4096),
                           vars(store.stats).copy()]
    store, cont = store_(n=3)
    obj = cont.object(9)
    for i in range(5):
        obj.update(str(i), "data", 0, bytes([i]) * 32)
        obj.fetch(str(i), "data", 0, 32)
    victim = store.devices[0].name
    keys = [(n, k) for lst in obj._extents.values() for e in lst
            for n, k in e.block_keys.items() if n == victim]
    store.fail_device(victim)
    out["rebuilt"] = store.rebuild(victim)
    out["rebuild"] = [cont.vcache.check(n, k, store.device(n).generation)
                      for n, k in keys]
    store.fail_device(store.devices[1].name)
    out["rebuild_reads"] = [obj.fetch(str(i), "data", 0, 32)
                            for i in range(5)]
    store, cont = store_()
    obj = cont.object(1)
    for i in range(8):
        obj.update(str(i), "data", 0, payload(1 << 16, seed=i))
        obj.fetch(str(i), "data", 0, 1 << 16)
    s = pkg.Scrubber(store, budget_bytes=2 << 16)
    out["scrub"] = [s.scrub_once()["scanned_bytes"] for _ in range(9)]
    return out


def test_verified_extent_cache_matches_reference():
    got = same(vcache)
    assert got["warm"]["checksum_skipped_bytes"] >= 3 * (1 << 16)
    assert any(got["overwrite"][0][:2]) and not any(got["overwrite"][0][2:])
    assert got["fail_recover"][:2] == [True, False]
    assert not any(got["rebuild"])
    assert got["scrub"][0] <= 2 << 16 and sum(got["scrub"]) >= 8 << 16


def _oracle_keystream(key, nonce, offset, n):
    """The reference's stream-cipher oracle (JAX, `cipher_ref`)."""
    import jax.numpy as jnp
    from repro.kernels.stream_cipher.ref import cipher_ref
    nw = (offset + n + 3) // 4
    words = np.asarray(cipher_ref(jnp.zeros(nw, jnp.uint32), key=key,
                                  nonce=nonce))
    return words.astype("<u4").view(np.uint8)[offset:offset + n]


def _plain_keystream(key, nonce, offset, n):
    """The port's `stream_cipher` plain version on the CPU."""
    from repro_torch.kernels.stream_cipher.ref import stream_cipher_torch
    zeros = torch.zeros(offset + n, dtype=torch.uint8)
    return stream_cipher_torch(zeros, key, nonce).numpy()[offset:]


def crypto(pkg, cases):
    out = []
    for n, offset, nonce in cases:
        c = pkg.smartnic.InlineCrypto(0xC0FFEE)
        data = np.frombuffer(payload(n, seed=n + offset), np.uint8)
        dst = np.empty(n, np.uint8)
        c.apply_into(dst, data, nonce=nonce, offset=offset)
        buf = data.copy()
        c.apply_into(buf, buf, nonce=nonce, offset=offset)
        assert np.array_equal(buf, dst)
        assert np.array_equal(c.apply(memoryview(data.tobytes()),
                                      nonce=nonce, offset=offset), dst)
        out.append(dst.tobytes())
    warm = pkg.smartnic.InlineCrypto(2)
    cold = pkg.smartnic.InlineCrypto(2, cache_bytes=0)
    data = np.frombuffer(payload(1 << 20, seed=4), np.uint8)
    first = warm.apply(data, nonce=11)
    gen = warm.stats.keystream_bytes_generated
    second = warm.apply(data, nonce=11)
    assert np.array_equal(first, second)
    assert np.array_equal(cold.apply(data, nonce=11), first)
    return {"applied": out, "warm": dict(vars(warm.stats)), "gen": gen,
            "cold": dict(vars(cold.stats)),
            "high": [warm.keystream(64, nonce=1 << 20).tobytes(),
                     warm.keystream(64, nonce=4097 << 20).tobytes()]}


def test_keystream_cache_matches_plain_version_and_oracle():
    page = REF.smartnic.KEYSTREAM_PAGE
    cases = [(1, 0, 42), (5, 3, 42), (4096, 0, 7), (1000, 4097, 42),
             (300, page - 7, 9), (2 * page + 11, 13, 123456)]
    got = same(crypto, cases)
    for (n, offset, nonce), out in zip(cases, got["applied"]):
        data = np.frombuffer(payload(n, seed=n + offset), np.uint8)
        ks = np.frombuffer(out, np.uint8) ^ data
        assert np.array_equal(ks, _plain_keystream(0xC0FFEE, nonce,
                                                   offset, n))
        assert np.array_equal(ks, _oracle_keystream(0xC0FFEE, nonce,
                                                    offset, n))
    assert got["warm"]["keystream_bytes_generated"] == got["gen"]
    assert got["cold"]["keystream_bytes_generated"] >= 1 << 20
    assert got["high"][0] != got["high"][1]


# ---------------------------------------------------------------------------
# Quorum writes: thread timing decides, the reference test's assertions


def test_quorum_write_returns_before_straggler_and_full_fanout_waits():
    c = PORT.Client(mode="host", transport="rdma", n_devices=3,
                    replication=3)
    try:
        straggler = c.devices[0]
        straggler.commit_delay_s = 0.5
        fd = c.open("/q", create=True)
        data = payload(BLOCK, seed=5)
        t0 = time.monotonic()
        c.pwrite(fd, data, 0)
        assert time.monotonic() - t0 < 0.4
        assert c.store.stats.quorum_acks >= 1
        assert c.pread(fd, BLOCK, 0) == data
        assert _wait(lambda: c.store.stats.background_commits >= 1)
        straggler.commit_delay_s = 0.0
        obj = c.container.object(c.dfs._open[fd].oid)
        ext = obj._extents[("0", AKEY)][0]
        assert _wait(lambda: ext.pending is None or ext.pending.complete)
        assert len(ext.block_keys) == 3
    finally:
        c.close()
    c = PORT.Client(mode="host", transport="rdma", n_devices=3,
                    replication=3, write_quorum=3)
    try:
        c.devices[0].commit_delay_s = 0.2
        fd = c.open("/full", create=True)
        t0 = time.monotonic()
        c.pwrite(fd, payload(4096, seed=6), 0)
        assert time.monotonic() - t0 >= 0.2
        assert c.store.stats.quorum_acks == 0
        c.devices[0].commit_delay_s = 0.0
    finally:
        c.close()


def test_quorum_straggler_failure_and_punch_race():
    c = PORT.Client(mode="host", transport="rdma", n_devices=3,
                    replication=3, n_staging_slots=4)
    try:
        straggler = c.devices[0]
        straggler.commit_delay_s = 0.15
        fd = c.open("/dl", create=True)
        data = payload(BLOCK, seed=11)
        c.pwrite(fd, data, 0)
        straggler.fail()
        straggler.commit_delay_s = 0.0
        assert _wait(lambda: c.store.stats.replica_demotions >= 1)
        for d in c.devices:
            d.writeback()
        ring = c.io.ring
        assert _wait(lambda: ring.donated_slots() == [])
        with ring._cv:
            assert sorted(ring._free) == list(range(4))
        assert c.pread(fd, BLOCK, 0) == data
    finally:
        c.close()
    store = PORT.object_store.ObjectStore(PORT.media.make_nvme_array(3))
    cont = store.create_pool("p").create_container(
        "c", replication=3, verified_cache=True, write_quorum=2)
    try:
        straggler = cont.placement(1, "0")[0]
        straggler.commit_delay_s = 0.2
        obj = cont.object(1)
        obj.update("0", AKEY, 0, payload(4096, seed=8))
        obj.punch("0", AKEY)
        straggler.commit_delay_s = 0.0
        assert _wait(lambda: sum(len(d._blocks) for d in store.devices) == 0)
        assert obj.fetch("0", AKEY, 0, 4096) == b"\x00" * 4096
    finally:
        store.close()
