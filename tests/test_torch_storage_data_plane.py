"""The data plane against the reference: `core/data_plane.py`'s
`MemoryRegistry` (register, rkey grant, revoke, expiry, deregister), the
scatter-gather verbs of `RDMATransport` and `TCPTransport`, and the
client's vectored data path over them (reference:
`tests/test_sg_data_path.py`, `tests/test_core_storage.py`).

Each scenario is made from numpy seeds and replayed through `repro.core`
and `repro_torch.core` (`device="cpu"`); `same` holds equal the bytes
that landed, every transport counter (copies a byte, segments, eager and
rendezvous messages, rkey resolves and cache hits, descriptors), which
ops were denied, and the control plane's RPC count.

Thread timing decides these outcomes, so they keep the reference test's
assertions only: two TCP streams through the shared kernel buffer at once
(`test_tcp_concurrent_streams_stay_isolated`).
"""
import threading
from dataclasses import asdict

import numpy as np
import pytest

from _torch_parity import (PORT, REF, counters, no_leaks, payload, same,
                           storage_env)  # noqa: F401
from repro.core.dfs import BLOCK

BOTH = pytest.mark.parametrize("pkg", [REF, PORT], ids=["ref", "port"])


def _iov(rng, size, n):
    """n disjoint (dst_off, src_off, length) runs inside `size` bytes."""
    cuts = np.sort(rng.choice(size // 64, 2 * n, replace=False)) * 64
    return [(int(a), int(size - b), int(b - a))
            for a, b in zip(cuts[::2], cuts[1::2])]


def transport_ops(pkg, seed):
    """Seeded single and vectored verbs through both transports; every
    destination buffer and the transports' counters."""
    dp = pkg.data_plane
    rng = np.random.default_rng(seed)
    size = 256 * 1024
    out = {}
    cli, srv = dp.MemoryRegistry("cli"), dp.MemoryRegistry("srv")
    src = cli.register(rng.integers(0, 256, size, dtype=np.uint8), "t")
    dst = srv.register(size, "t")
    rk = srv.grant(dst, "rw")
    x = dp.RDMATransport(cli, srv)
    x.write(rk.token, "t", 0, src, 0, dp.EAGER_LIMIT)
    x.write(rk.token, "t", 0, src, 0, dp.EAGER_LIMIT + 1)
    x.write(rk.token, "t", 0, src, 0, size)
    for n in (1, 3, 17):
        iov = [(d, src, s, ln) for d, s, ln in _iov(rng, size, n)]
        x.write_sg(rk.token, "t", iov)
        back = cli.register(size, "t")
        x.read_sg(rk.token, "t", [(d, back, s, ln) for d, _r, s, ln in iov])
        out[f"sg{n}"] = bytes(back.buf)
    x.read(rk.token, "t", 100, src, 7, 4000)
    out["rdma_dst"] = bytes(dst.buf)
    out["rdma_src"] = bytes(src.buf)
    out["rdma"] = asdict(x.stats)
    cli2, srv2 = dp.MemoryRegistry("cli"), dp.MemoryRegistry("srv")
    s2 = cli2.register(rng.integers(0, 256, size, dtype=np.uint8), "t")
    d2 = srv2.register(size, "t")
    t = dp.TCPTransport(cli2, srv2)
    t.write(d2, 0, s2, 0, size)
    t.write(d2, 5, s2, 11, 3 * dp.MTU + 1)
    t.read(d2, 64, s2, 0, 10_000)
    out["tcp_dst"] = bytes(d2.buf)
    out["tcp_src"] = bytes(s2.buf)
    out["tcp"] = asdict(t.stats)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_transport_verbs_move_the_same_bytes_and_count_the_same(seed):
    got = same(transport_ops, seed)
    assert got["rdma"]["eager"] >= 1 and got["rdma"]["rendezvous"] >= 1
    assert got["tcp"]["copy_bytes"] == 2 * got["tcp"]["bytes_moved"]


def denials(pkg):
    """Which of a fixed list of verbs the registry refuses."""
    dp = pkg.data_plane
    cli, srv = dp.MemoryRegistry("cli"), dp.MemoryRegistry("srv")
    dst = srv.register(64 * 1024, "tenantA")
    src = cli.register(64 * 1024, "tenantA")
    x = dp.RDMATransport(cli, srv)
    ro = srv.grant(dst, "r", ttl_s=1000)
    rw = srv.grant(dst, "rw")
    iov = [(0, src, 0, 4096), (8192, src, 4096, 4096)]
    tries = [
        ("write r-only", lambda: x.write(ro.token, "tenantA", 0, src, 0, 16)),
        ("cross-tenant read", lambda: x.read(ro.token, "tenantB", 0, src, 0,
                                             16)),
        ("out of bounds", lambda: x.read(ro.token, "tenantA", 65530, src, 0,
                                         16)),
        ("read", lambda: x.read(ro.token, "tenantA", 0, src, 0, 16)),
        ("write_sg", lambda: x.write_sg(rw.token, "tenantA", iov)),
        ("write_sg cached", lambda: x.write_sg(rw.token, "tenantA", iov)),
        ("cross-tenant sg", lambda: x.write_sg(rw.token, "tenantB", iov)),
        ("sg out of bounds", lambda: x.write_sg(
            rw.token, "tenantA", [(64 * 1024 - 16, src, 0, 4096)])),
        ("revoke", lambda: srv.revoke(ro.token)),
        ("revoked read", lambda: x.read(ro.token, "tenantA", 0, src, 0, 16)),
        ("revoked cached sg", lambda: (srv.revoke(rw.token),
                                       x.write_sg(rw.token, "tenantA", iov))),
        ("expired", lambda: x.read_sg(
            srv.grant(dst, "rw", ttl_s=-1.0).token, "tenantA", iov)),
    ]
    rk = srv.grant(dst, "rw")
    tries += [("fresh sg", lambda: x.write_sg(rk.token, "tenantA", iov)),
              ("deregister", lambda: srv.deregister(dst)),
              ("deregistered sg", lambda: x.write_sg(rk.token, "tenantA",
                                                     iov))]
    refused = []
    for name, fn in tries:
        try:
            fn()
            refused.append((name, False))
        except dp.AccessError:
            refused.append((name, True))
    return {"refused": refused, "stats": asdict(x.stats)}


def test_registry_refuses_the_same_verbs():
    got = dict(same(denials)["refused"])
    assert got["write r-only"] and got["cross-tenant read"]
    assert got["revoked cached sg"] and got["deregistered sg"]
    assert not got["write_sg cached"]


CLIENTS = [dict(mode=m, transport=t, zero_copy=z)
           for m in ("host", "dpu") for t in ("rdma", "tcp")
           for z in (True, False)] + [dict(mode="host", transport="rdma",
                                           legacy=True),
                                      dict(mode="host", transport="rdma",
                                           inline_encryption=True)]


def vectored_client(pkg, cfg):
    """Writes, vectored writes, reads, vectored reads and reads into a
    registered region on one client; returns every byte read, the counters
    and the RPCs each step took."""
    c = pkg.Client(**cfg)
    out = {"reads": [], "rpcs": []}
    try:
        fd = c.open("/v", create=True)
        rng = np.random.default_rng(4)
        data = payload(4 * BLOCK + 4096, seed=9)
        out["rpcs"].append(c.control.rpc_count)
        out["n"] = [c.pwrite(fd, data, 0)]
        bufs = [payload(BLOCK - 7, seed=10), payload(BLOCK + 99, seed=11),
                payload(51, seed=12)]
        out["n"].append(c.pwritev(fd, bufs, 3 * BLOCK + 5))
        out["rpcs"].append(c.control.rpc_count)
        for _ in range(6):
            off = int(rng.integers(0, 5 * BLOCK))
            n = int(rng.integers(1, 2 * BLOCK))
            out["reads"].append(c.pread(fd, n, off))
        out["reads"].append(c.preadv(fd, [len(b) for b in bufs],
                                     3 * BLOCK + 5))
        for off, n in [(4096, 4096), (100, 37), (BLOCK - 10, 30), (0, 1)]:
            out["reads"].append(c.pread(fd, n, off))
        if not cfg.get("legacy") and cfg["mode"] == "host":
            dst = c.register_region(2 * BLOCK)
            for _ in range(2):
                c.pread_into(fd, 2 * BLOCK, 77, dst, 0)
                out["reads"].append(bytes(dst.buf))
            c.io.drop_dst_rkey(dst)         # the region's capability dies
            c.client_registry.deregister(dst)
        out["rpcs"].append(c.control.rpc_count)
        out["stat"] = c.dfs.stat("/v")["size"]
        c.close_fd(fd)
        out["rpcs"].append(c.control.rpc_count)
        out["counters"] = counters(c)
        no_leaks(c)
        return out
    finally:
        c.close()


@pytest.mark.parametrize("cfg", CLIENTS, ids=lambda d: "-".join(
    str(v) if not isinstance(v, bool) else (k if v else f"no_{k}")
    for k, v in d.items()))
def test_vectored_client_path_matches_reference(cfg):
    got = same(vectored_client, cfg)
    t = {k.split(".", 1)[1]: v for k, v in got["counters"].items()
         if k.startswith("transport.")}
    if cfg["mode"] == "host" and not cfg.get("legacy"):
        per_byte = 1 if cfg["transport"] == "rdma" else 2
        assert t["copy_bytes"] == per_byte * t["bytes_moved"]
        assert got["rpcs"][1] == got["rpcs"][0]      # the writes are RPC-free


def extents(pkg, seed):
    """Out-of-order epoch arrival against a shadow, and aggregation."""
    os_ = pkg.object_store
    store = os_.ObjectStore(pkg.media.make_nvme_array(4))
    obj = store.create_pool("p").create_container("c").object(1)
    span = 4096
    rng = np.random.default_rng(seed)
    ops = [(e, int(rng.integers(0, span - 64)),
            rng.integers(0, 256, int(rng.integers(1, 64)),
                         dtype=np.uint8).tobytes()) for e in range(1, 401)]
    shuffled = list(ops)
    rng.shuffle(shuffled)
    for epoch, off, data in shuffled:
        obj.update("0", "data", off, data, epoch=epoch)
    got = obj.fetch("0", "data", 0, span)
    into = np.empty(span, np.uint8)
    obj.fetch_into("0", "data", 0, span, into)
    agg = os_.ObjectStore(pkg.media.make_nvme_array(2))
    aobj = agg.create_pool("p").create_container("c", aggregate=True) \
        .object(1)
    for i in range(32):
        aobj.update("0", "data", 0, bytes([i]) * 256)
    return {"fetch": got, "into": into.tobytes(),
            "snapshot": obj.fetch("0", "data", 0, span, epoch=200),
            "aggregated": len(aobj._extents[("0", "data")]),
            "live_blocks": sum(len(d._blocks) for d in agg.devices),
            "agg_read": aobj.fetch("0", "data", 0, 256),
            "checksums": [pkg.media.checksum(payload(n, seed=n))
                          for n in (0, 1, 3, 4, 100, 4096, 8193)]}


@pytest.mark.parametrize("seed", [7, 8])
def test_extents_epochs_and_checksums_match_reference(seed):
    got = same(extents, seed)
    assert got["fetch"] == got["into"]
    assert got["aggregated"] < 32


def doorbells(pkg):
    dpu = pkg.smartnic.DPURuntime(n_cores=4)
    dpu.register("sq", lambda x: x * x)
    dpu.start()
    try:
        before = dpu.doorbells
        tags = dpu.submit_many([("sq", {"x": i}) for i in range(8)])
        after_batch = dpu.doorbells - before
        done = dpu.wait_all(tags)
        for i in range(8):
            dpu.submit("sq", x=i)
        dpu.drain(8)
        return {"batch": after_batch, "all": dpu.doorbells - before,
                "results": [done[t].result for t in tags]}
    finally:
        dpu.stop()


def test_dpu_doorbells_match_reference():
    got = same(doorbells)
    assert got["batch"] == 1 and got["all"] == 9


@BOTH
def test_tcp_concurrent_streams_stay_isolated(pkg):
    """Timing: the two streams interleave as the scheduler runs them."""
    c = pkg.Client(mode="host", transport="tcp")
    try:
        fds = [c.open(f"/s{i}", create=True) for i in range(2)]
        datas = [payload(2 * BLOCK + 333 * i, seed=20 + i) for i in range(2)]
        errors = []

        def stream(i):
            try:
                for _ in range(3):
                    c.pwrite(fds[i], datas[i], 0)
                    assert c.pread(fds[i], len(datas[i]), 0) == datas[i]
            except Exception as e:          # noqa: BLE001 - reported below
                errors.append(e)
        ts = [threading.Thread(target=stream, args=(i,), name=f"arm-s{i}")
              for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert not errors, errors
        no_leaks(c)
    finally:
        c.close()
