"""The paper's performance model against the reference: `core/fio.py`
(`local_fio`, `remote_spdk`), `core/transport_model.py`, `core/sim.py`'s
`mva` and `ROS2Client.model_throughput` / `model_iops` (reference:
`tests/test_paper_claims.py`, `tests/test_properties.py`).

Over the grid of `tests/test_paper_claims.py` the port's functions give
the same floats as the reference's, and the port's client gives those of
`benchmarks/fig5_dfs_offload.py` `dfs_perf` (which the test imports; the
port does not). The claims themselves are then checked on the port's
numbers. `mva` is held on seeded station sets. Nothing here depends on
thread timing.
"""
import numpy as np
import pytest

from _torch_parity import same, storage_env  # noqa: F401
from benchmarks.fig5_dfs_offload import dfs_perf

KiB, MiB, GiB = 1 << 10, 1 << 20, 1 << 30
JOBS = (1, 2, 4, 8, 16)


def fio_grid(pkg):
    fio = pkg.fio
    out = {}
    for n_dev in (1, 4):
        for io in (4 * KiB, MiB):
            for wl in ("read", "write", "randread", "randwrite"):
                for jobs in JOBS:
                    out[("local", n_dev, io, wl, jobs)] = fio.local_fio(
                        n_dev, io, wl, jobs)
    for t in ("tcp", "rdma"):
        for io in (4 * KiB, MiB):
            for wl in ("read", "write", "randread"):
                for cores in (1, 4, 8, 16):
                    out[("remote", t, io, wl, cores)] = fio.remote_spdk(
                        t, io, wl, cores, cores)
    return out


def test_fio_and_spdk_floats_match_reference():
    got = same(fio_grid)
    r = got[("local", 1, MiB, "read", 8)][1] / GiB
    assert 5.0 <= r <= 5.8
    i1 = got[("local", 1, 4 * KiB, "randread", 1)][0]
    assert 60e3 <= i1 <= 100e3
    t16 = got[("remote", "tcp", 4 * KiB, "randread", 16)][0]
    r16 = got[("remote", "rdma", 4 * KiB, "randread", 16)][0]
    assert r16 > 1.8 * t16


def transport_model(pkg):
    tm = pkg.transport_model
    out = {}
    for plat in ("HOST", "DPU"):
        for t in ("tcp", "rdma"):
            for io in (4 * KiB, 64 * KiB, MiB):
                for write in (False, True):
                    key = (plat, t, io, write)
                    out[key] = [(s.name, s.demand_s, s.servers, s.kind,
                                 s.degrade)
                                for s in tm.client_stations(
                                    getattr(tm, plat), t, io, write, 4)
                                + tm.server_stations(t, io, write)
                                + tm.network_stations(io)]
    return out


def test_transport_model_stations_match_reference():
    same(transport_model)


def _stations(pkg, seed):
    rng = np.random.default_rng(seed)
    return [pkg.sim.Station(f"s{i}", float(rng.uniform(1e-7, 1e-3)),
                            servers=int(rng.integers(1, 9)),
                            kind=str(rng.choice(["queue", "queue", "delay"])))
            for i in range(int(rng.integers(1, 6)))]


def mva_sets(pkg):
    out = []
    for seed in range(40):
        st = _stations(pkg, seed)
        out.append([pkg.sim.mva(st, n) for n in (1, 3, 8, 17, 64)])
    return out


def test_mva_matches_reference_on_seeded_station_sets():
    got = same(mva_sets)
    for row in got:
        xs = [x for x, _ in row]
        assert all(b >= a - 1e-9 for a, b in zip(xs, xs[1:]))


def client_model(pkg):
    out = {}
    for mode in ("host", "dpu"):
        for t in ("tcp", "rdma"):
            for n_dev in (1, 4):
                c = pkg.Client(mode=mode, transport=t, n_devices=n_dev)
                try:
                    for io in (4 * KiB, MiB):
                        for write in (False, True):
                            for jobs in JOBS:
                                out[(mode, t, n_dev, io, write, jobs)] = (
                                    c.model_iops(io, write, jobs),
                                    c.model_throughput(io, write, jobs))
                finally:
                    c.close()
    return out


def test_client_model_matches_reference_and_fig5():
    got = same(client_model)
    for (mode, t, n_dev, io, write, jobs), (iops, bw) in got.items():
        assert iops == dfs_perf(mode, t, io, write, n_dev, jobs)
        assert bw == iops * io
    # the paper's claims, on the port's numbers
    def perf(mode, t, io, write, n_dev, jobs):
        return got[(mode, t, n_dev, io, write, jobs)][0]
    assert 5.0 <= perf("host", "tcp", MiB, False, 1, 16) * MiB / GiB <= 6.2
    caps = [perf("dpu", "tcp", MiB, False, 4, j) * MiB / GiB
            for j in (1, 4, 16)]
    assert all(1.5 <= c <= 3.2 for c in caps) and caps[-1] < caps[0]
    h = perf("host", "rdma", 4 * KiB, False, 1, 16)
    d = perf("dpu", "rdma", 4 * KiB, False, 1, 16)
    assert 0.60 <= d / h <= 0.80
    for mode in ("host", "dpu"):
        for io in (MiB, 4 * KiB):
            for write in (False, True):
                assert perf(mode, "rdma", io, write, 4, 16) >= \
                    0.99 * perf(mode, "tcp", io, write, 4, 16)


@pytest.mark.parametrize("n_targets", [2, 8])
def test_striped_client_model_matches_reference(n_targets):
    def model(pkg):
        c = pkg.Client(mode="host", transport="rdma", n_targets=n_targets)
        try:
            return [(c.model_iops(io, w, j), c.model_throughput(io, w, j))
                    for io in (4 * KiB, MiB) for w in (False, True)
                    for j in JOBS]
        finally:
            c.close()
    same(model)
