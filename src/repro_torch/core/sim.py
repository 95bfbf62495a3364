"""Closed queueing-network performance model (exact MVA + extensions).

Every benchmark number in figs 3/4/5 derives from this model: an I/O
request cycles through a set of *stations* (client cores, a shared kernel
path, the network link, server cores, SSDs). Mean-Value Analysis yields
throughput as a function of the number of concurrent requests — saturating
curves with soft knees, exactly the shape of the paper's plots.

Stations:
  * kind="queue": FCFS queueing server. Multi-server (c>1) stations use the
    Seidmann approximation (D/c queueing + D*(c-1)/c delay).
  * kind="delay": pure latency, no queueing (e.g. propagation, NIC DMA).
  * degrade: optional per-concurrency service-time inflation, modeling the
    DPU TCP receive-path collapse under concurrency the paper observes
    (Fig. 5a bottom: 1 MiB reads *degrade* as jobs increase).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Sequence, Tuple


@dataclass(frozen=True)
class Station:
    name: str
    demand_s: float                 # mean service demand per I/O (seconds)
    servers: int = 1
    kind: str = "queue"             # "queue" | "delay"
    degrade: float = 0.0            # fractional demand growth per in-flight op


def mva(stations: Sequence[Station], n_jobs: int,
        think_s: float = 0.0) -> Tuple[float, Dict[str, float]]:
    """Exact single-class MVA. Returns (throughput ops/s, residence per stn)."""
    # expand multi-server stations via Seidmann's approximation
    queue: List[Station] = []
    delay = think_s
    for st in stations:
        if st.kind == "delay":
            delay += st.demand_s
        elif st.servers > 1:
            queue.append(replace(st, demand_s=st.demand_s / st.servers,
                                 servers=1))
            delay += st.demand_s * (st.servers - 1) / st.servers
        else:
            queue.append(st)

    q = [0.0] * len(queue)          # mean queue length per station
    x = 0.0
    for n in range(1, n_jobs + 1):
        r = []
        for i, st in enumerate(queue):
            d = st.demand_s * (1.0 + st.degrade * (n - 1))
            r.append(d * (1.0 + q[i]))
        r_total = sum(r) + delay
        x = n / r_total if r_total > 0 else float("inf")
        q = [x * ri for ri in r]
    res = {st.name: ri for st, ri in zip(queue, q)}
    return x, res


def throughput_bytes(stations: Sequence[Station], n_jobs: int,
                     io_size: int, think_s: float = 0.0) -> float:
    """B/s for a closed loop of n_jobs requests of io_size each."""
    x, _ = mva(stations, n_jobs, think_s)
    return x * io_size


GiB = 1024 ** 3
MiB = 1024 ** 2
KiB = 1024
