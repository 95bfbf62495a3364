"""The traced run's reading of the device: one steady wave after the
window (its reads, its prefill and its first `steps` decode steps) under
torch.profiler, reduced to a summary.

The host's phases are named ranges in the trace (`HOST_PHASES`):
store_read (the clients' reads), wave_form (from the reads' end to the
prefill's call: the wave's requests and its stacked prompts), prefill_host
(the prefill's replay and the read of its tokens) and decode_host (the
decode steps and their token reads). A device operation belongs to the
phase in which it started; an idle gap of the device to the phase that
covers its midpoint, or "other".
"""
from __future__ import annotations

import time
from typing import Dict, List

HOST_PHASES = ("store_read", "wave_form", "prefill_host", "decode_host")
TOP = 10
NAME_CHARS = 120            # a kernel's name as the result line gives it


class _Phases:
    """The host's named ranges, one open at a time."""

    def __init__(self):
        from torch.profiler import record_function
        self._rf = record_function
        self.open = None

    def enter(self, name: str) -> None:
        self.leave()
        self.open = self._rf(name)
        self.open.__enter__()

    def leave(self) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None


def _events(prof) -> tuple:
    """(device operations, host phase ranges) as (name, start_us, end_us)
    lists, from the profiler's raw records (kineto's, on one clock):
    building its per-event objects for a whole wave's 10^5 kernels would
    take longer than the wave."""
    from torch.autograd import DeviceType
    device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        span = (name, ev.start_ns() / 1e3, ev.end_ns() / 1e3)
        if name in HOST_PHASES:
            # kineto mirrors each host range on the device's timeline too
            if ev.device_type() != DeviceType.CUDA:
                host.append(span)
        elif ev.device_type() == DeviceType.CUDA:
            device.append(span)
    return device, host


def traced_wave(eng, store, traffic, steps: int = 32) -> dict:
    """One wave of the closed loop with its reads, prefill and first
    `steps` decode steps traced; its summary (`summarize`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from portbench.serve import run_wave
    phases = _Phases()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    stopped = []

    def sync() -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def stop() -> None:
        if not stopped:
            phases.leave()
            sync()
            prof.stop()
            stopped.append(time.perf_counter())

    def on_step(kind: str, index: int) -> None:
        if kind == "prefill":
            phases.enter("prefill_host")
        elif index == 1:
            phases.enter("decode_host")
        elif index == steps + 1:
            stop()

    # the reads are the wave's first work: store_read opens before them
    # and wave_form when the last read is in
    read = store.read

    def traced_read(reqs):
        phases.enter("store_read")
        out = read(reqs)
        phases.enter("wave_form")
        return out

    sync()
    prof.start()
    store.read, eng.on_step = traced_read, on_step
    t = time.perf_counter()
    try:
        run_wave(eng, store, traffic, t)
    finally:
        store.read, eng.on_step = read, None
        stop()
    t_parse = time.perf_counter()
    device, host = _events(prof)
    out = summarize(device, host)
    out["parse_s"] = time.perf_counter() - t_parse
    out["traced_host_s"] = stopped[0] - t
    return out


def _phase_at(host: List[tuple], t: float) -> str:
    for name, a, b in host:
        if a <= t < b:
            return name
    return "other"


def summarize(device: List[tuple], host: List[tuple]) -> dict:
    """From device operations and host phases (name, start_us, end_us):
    the traced span (from the first phase's start to the last's end),
    the device's busy seconds in it (the union of its operations), its
    operations by name overall and by the phase they started in, and its
    idle gaps summed by phase."""
    if not host:
        raise ValueError("no host phase in the trace")
    span0 = min(a for _, a, _ in host)
    span1 = max(b for _, _, b in host)
    ops = sorted(((n, max(a, span0), min(b, span1)) for n, a, b in device
                  if b > span0 and a < span1), key=lambda o: o[1])
    busy, gaps = 0.0, []
    cursor = span0
    for _, a, b in ops:
        if a > cursor:
            gaps.append((cursor, a))
        if b > cursor:
            busy += b - max(a, cursor)
            cursor = b
    if span1 > cursor:
        gaps.append((cursor, span1))
    by_name: Dict[str, list] = {}
    by_phase: Dict[str, Dict[str, list]] = {}
    for n, a, b in ops:
        for table in (by_name,
                      by_phase.setdefault(_phase_at(host, a), {})):
            c = table.setdefault(n, [0, 0.0])
            c[0] += 1
            c[1] += (b - a) / 1e6
    idle: Dict[str, float] = {}
    for a, b in gaps:
        p = _phase_at(host, (a + b) / 2)
        idle[p] = idle.get(p, 0.0) + (b - a) / 1e6
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (span1 - span0) / 1e6, "busy_s": busy / 1e6,
        "device_ops": len(ops), "ops_by_name": by_name,
        "ops_by_phase": by_phase,
        "idle_by_phase": idle,
        "longest_gaps": [[_phase_at(host, (a + b) / 2), (b - a) / 1e6,
                          (a - span0) / 1e6] for a, b in longest],
        "phases_s": {n: (b - a) / 1e6 for n, a, b in host},
    }


def top_ops(ops: Dict[str, list], n: int = TOP) -> list:
    """[name, seconds, count] of the n operations that took most time,
    names cut to NAME_CHARS."""
    best = sorted(ops.items(), key=lambda x: -x[1][1])[:n]
    return [[name[:NAME_CHARS], c[1], c[0]] for name, c in best]


def breakdown(summary: dict) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time, and the idle gaps summed by what the host was doing."""
    idle = sorted(summary["idle_by_phase"].items(), key=lambda x: -x[1])
    return {"device_ops": [[n, s] for n, s, _ in
                           top_ops(summary["ops_by_name"])],
            "idle_gaps": [[n, s] for n, s in idle[:TOP]]}
