"""FIO-style workload models: local io_uring baseline (paper Fig. 3) and
remote SPDK NVMe-oF (paper Fig. 4).

Calibration targets (paper §4.2):
  1 SSD 1 MiB: seq/rand read ~5.0-5.6 GiB/s, write ~2.7 GiB/s, flat in jobs
  4 SSD 1 MiB: read ~20-22 GiB/s, write ~10.6-10.7 GiB/s (near-linear)
  4 KiB IOPS: ~80 K @1 job -> ~600 K @16 jobs, drive-count insensitive
              (host submission-path limit, not media)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core import transport_model as tm
from repro_torch.core.media import MediaPerf, make_nvme_array, striped_stations
from repro_torch.core.sim import GiB, KiB, MiB, Station, mva

IODEPTH = 8                      # FIO iodepth per job (closed-loop jobs)

# io_uring submission/completion path per I/O on one core, split into the
# per-SQE cost (sqe/cqe handling, page pinning) and the per-doorbell
# syscall/batch cost amortized over the queue depth — the same SQ/CQ
# model the async client's `io_depth` knob drives, so the bench's 4× gate
# calibrates against the modeled ceiling at ITS depth instead of a magic
# constant. At the calibration depth (IODEPTH=8) the per-op sum is
# bit-identical to the historical flat 10.0e-6 constant.
IOURING_PER_SQE = 8.6e-6
IOURING_DOORBELL = 11.2e-6
BLOCK_LAYER_SHARED = 1.6e-6


def iouring_per_op(iodepth: int = IODEPTH) -> float:
    """Modeled io_uring per-op service time at a given queue depth: the
    doorbell cost amortizes over every SQE it submits."""
    return IOURING_PER_SQE + IOURING_DOORBELL / max(1, int(iodepth))


# historical flat constant (kept for reference/back-compat; equals the
# split model at the calibration depth)
IOURING_PER_OP = iouring_per_op(IODEPTH)

WORKLOADS = ("read", "write", "randread", "randwrite")


def is_write(workload: str) -> bool:
    return "write" in workload


def local_stations(n_dev: int, io_size: int, workload: str,
                   jobs: int, iodepth: int = IODEPTH) -> List[Station]:
    devs = make_nvme_array(n_dev)
    write = is_write(workload)
    out = [
        Station("host:iouring", iouring_per_op(iodepth), servers=jobs),
        Station("host:blklayer", BLOCK_LAYER_SHARED, servers=1),
    ]
    out += striped_stations(devs, io_size, write)
    return out


def local_fio(n_dev: int, io_size: int, workload: str, jobs: int,
              iodepth: int = IODEPTH):
    """Returns (ops/s, bytes/s) for the local io_uring benchmark."""
    x, _ = mva(local_stations(n_dev, io_size, workload, jobs, iodepth),
               jobs * iodepth)
    return x, x * io_size


def remote_spdk_stations(transport: str, io_size: int, workload: str,
                         client_cores: int, server_cores: int,
                         n_dev: int = 1) -> List[Station]:
    """Remote SPDK NVMe-oF target: no DFS layer, SPDK engine, host client."""
    write = is_write(workload)
    devs = make_nvme_array(n_dev)
    return (tm.client_stations(tm.HOST, transport, io_size, write,
                               client_cores, dfs=False)
            + tm.network_stations(io_size)
            + tm.server_stations(transport, io_size, write, server_cores,
                                 engine="spdk")
            + striped_stations(devs, io_size, write))


def remote_spdk(transport: str, io_size: int, workload: str,
                client_cores: int, server_cores: int, n_dev: int = 1,
                iodepth: int = IODEPTH):
    """Returns (ops/s, bytes/s) for the remote SPDK benchmark; concurrency
    scales with client cores (one FIO job per core)."""
    x, _ = mva(remote_spdk_stations(transport, io_size, workload,
                                    client_cores, server_cores, n_dev),
               client_cores * iodepth)
    return x, x * io_size
