"""Calibrated per-I/O service demands for every (platform x transport) pair.

The paper's central comparison — TCP vs RDMA on a server-grade host vs a
BlueField-3 DPU — reduces to *which stations exist on the I/O path and how
expensive they are*:

  * TCP: kernel stack -> per-I/O syscall/softirq CPU work on BOTH ends,
    per-byte copy costs (two copies), and a SHARED serialized receive path
    (softirq / single connection) that caps IOPS regardless of core count.
    On the BlueField-3's Arm cores the RX path is several times weaker and
    degrades under concurrency (the paper's Fig. 5a bottom).
  * RDMA: kernel bypass -> tiny doorbell/completion demands, zero-copy DMA
    by the NIC. No shared software station: IOPS scale with cores, and the
    DPU penalty is only its slower per-core doorbell handling.

Calibration targets (paper §4):
  Fig 4: remote SPDK 4 KiB — RDMA >> TCP, RDMA scales with cores, TCP caps.
  Fig 5 host:  TCP ~5-6 GiB/s (1 SSD) / ~10 GiB/s (4 SSD, link cap),
               0.4-0.6 M IOPS; RDMA ~6.4 / 10-11 GiB/s.
  Fig 5 DPU:   TCP reads 1.6-3.1 GiB/s degrading with concurrency, writes
               ~10 GiB/s; 0.18-0.23 M IOPS. RDMA == host at 1 MiB; 4 KiB
               20-40% below host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.core.sim import GiB, KiB, MiB, Station

LINK_BW = 100e9 / 8            # 100 Gbps switch -> 12.5 GB/s
MTU = 9000                     # jumbo frames


@dataclass(frozen=True)
class PlatformPerf:
    """Per-core protocol-processing capability of the client platform."""
    name: str
    core_scale: float          # service-time multiplier vs server-grade x86
    n_cores: int
    copy_bw: float             # single-core memcpy bandwidth (B/s)
    tcp_rx_shared_s: float     # serialized TCP receive-path demand per I/O
    tcp_rx_byte_bw: float      # shared RX path byte throughput (B/s)
    tcp_rx_degrade: float      # per-inflight-op RX *byte-path* inflation
    rdma_extra_s: float        # extra per-op doorbell/CQ cost (Arm complex)


HOST = PlatformPerf(
    name="host-epyc7443", core_scale=1.0, n_cores=48,
    copy_bw=12 * GiB, tcp_rx_shared_s=1.85e-6, tcp_rx_byte_bw=11.0 * GiB,
    tcp_rx_degrade=0.0, rdma_extra_s=0.0)

# BlueField-3: 16 Cortex-A78AE cores; TCP RX terminates on the Arm complex.
DPU = PlatformPerf(
    name="bluefield3", core_scale=4.0, n_cores=16,
    copy_bw=4 * GiB, tcp_rx_shared_s=4.6e-6, tcp_rx_byte_bw=2.9 * GiB,
    tcp_rx_degrade=0.006, rdma_extra_s=6.0e-6)

# Base per-I/O CPU demands on a server-grade core (seconds).
TCP_PER_OP = 6.0e-6            # syscalls, TCP/IP stack, interrupts
TCP_PER_SEG = 0.35e-6          # per-MTU segment processing
RDMA_PER_OP = 1.35e-6          # post WQE + poll CQE (kernel bypass)
DFS_PER_OP = 1.3e-6            # DAOS/DFS client translation + checksum
SPDK_SRV_PER_OP = 1.0e-6       # server SPDK/DAOS engine per-I/O (polling)
SRV_CORES_DEFAULT = 16


def client_stations(platform: PlatformPerf, transport: str, io_size: int,
                    write: bool, n_cores: int, dfs: bool = True) -> List[Station]:
    """Stations contributed by the client (host CPU or DPU)."""
    scale = platform.core_scale
    out: List[Station] = []
    per_core = (DFS_PER_OP if dfs else 0.0) * scale
    if transport == "tcp":
        per_core += TCP_PER_OP * scale
        per_core += TCP_PER_SEG * scale * max(1, io_size // MTU)
        # two-copy data path burns client core cycles per byte
        per_core += io_size / (platform.copy_bw / scale)
        out.append(Station("client:cores", per_core, servers=n_cores))
        if not write:
            # serialized receive path (softirq / connection) — the kernel
            # station RDMA bypasses. Dominates DPU reads. Per-op part is
            # stable; the byte path thrashes under concurrency (Fig 5a).
            out.append(Station("client:tcp-rx-op", platform.tcp_rx_shared_s,
                               servers=1))
            out.append(Station("client:tcp-rx-bytes",
                               io_size / platform.tcp_rx_byte_bw,
                               servers=1, degrade=platform.tcp_rx_degrade))
        else:
            out.append(Station(
                "client:tcp-tx",
                0.5 * platform.tcp_rx_shared_s
                + io_size / (4.0 * platform.tcp_rx_byte_bw),
                servers=1))
    else:  # rdma
        per_core += RDMA_PER_OP * scale + platform.rdma_extra_s
        out.append(Station("client:cores", per_core, servers=n_cores))
        # zero-copy: NIC DMA moves bytes; no shared software station.
    return out


def network_stations(io_size: int) -> List[Station]:
    return [Station("net:link", io_size / LINK_BW, servers=1),
            Station("net:prop", 2.0e-6, kind="delay")]


def server_stations(transport: str, io_size: int, write: bool,
                    n_cores: int = SRV_CORES_DEFAULT,
                    engine: str = "daos") -> List[Station]:
    per_core = SPDK_SRV_PER_OP
    if engine == "daos":
        per_core += 0.8e-6               # object/metadata service work
    out = [Station("srv:cores", per_core, servers=n_cores)]
    if transport == "tcp":
        out.append(Station("srv:tcp", TCP_PER_OP
                           + TCP_PER_SEG * max(1, io_size // MTU)
                           + io_size / (14 * GiB), servers=min(8, n_cores)))
        out.append(Station("srv:tcp-rx", 1.1e-6 + (io_size / (12 * GiB) if write else 0.0),
                           servers=1))
    else:
        out.append(Station("srv:rdma", RDMA_PER_OP, servers=n_cores))
    return out
