#!/usr/bin/env python3
"""The program's own spans over one traced wave, on the device trace's
clock.

`program_wave` runs one more wave through `trace.traced_wave` with the
program's span tracer (`repro_torch.common.tracing`) on beside the
profiler. Its summary is `traced_wave`'s without the operation tables
(`ops_by_name`, `ops_by_phase`), and besides:

    spans             per span name, over the spans that lie in the traced
                      span: count, total and self seconds, mean and p95 ms;
                      for dpu.op its CPU share (thread CPU over wall time)
    idle_by_span      the device's idle gaps split over time by the
                      innermost span open on the engine's thread
                      ("no_span" where none is); it sums to the idle
                      seconds of `idle_by_phase`. (A gap is split, not put
                      down whole at its midpoint: a wave's reads are one
                      gap of the card's.)
    idle_in_dpu_wait  the idle time in dpu.wait split again over time among
                      the innermost spans open on the Arm cores, each core
                      a 1 / n share ("arm_idle" where none is)
    inside            each dpu.wait against the store_read phase, each
                      decode.step and decode.token_read against
                      decode_host: the spans checked, those outside, the
                      largest overhang in us
    requests          [rid, first token s, last token s] after the wave's
                      engine.wave opened: the ends of its prefill.token_read
                      and of the decode.token_read of the step that
                      finished it
    clock_drift_us    the drift of the tracer's clock pairs over the wave

A program without the tracer gives None.

    python3 portbench/spans.py --workload granite-3-2b.rag --seed 7 \
        --seconds 50

runs a cell as `run.py ... --trace 1` does, with that wave after the
traced one and then one more with the tracer on and no profiler
(`bare_wave`): its detail line holds their summaries as `trace.program`
and `trace.program_no_profiler`, and its last line (`portbench spans:
{...}`) the readings of `PROGRAM_METRICS`.

`PROGRAM_METRICS` read the wave without the profiler (`bare_table`): the
profiler's cost on each CUDA call lands in the spans of the program that
makes it (a decode step's graph launch reads 11-15 ms under it and ~2 ms
without), and the timed window runs without it. The profiled wave is
what places the program's spans against the device's idle gaps.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
PROGRAM_METRICS = ("dpu_queue_ms.p95", "dpu_op_ms", "decode_host_ms")
BARE = "program_no_profiler"    # the trace key of `bare_wave`'s summary
ARM_OP = "dpu.op"               # the span every Arm core's work opens with
WAIT = "dpu.wait"
# decode.step opens before decode_host does: the harness opens the phase
# in the first step's replay call (`serve.timed_engine`), so the first
# step leads it by that hook's time; its token reads lie inside
CHECKS = (("dpu.wait", "store_read"), ("decode.step", "decode_host"),
          ("decode.token_read", "decode_host"))


def gaps(device: List[tuple], host: List[tuple]) -> List[tuple]:
    """The device's idle gaps (start_us, end_us) over the traced span
    (from the first host phase's start to the last's end), found as
    `trace.summarize` finds them."""
    span0 = min(a for _, a, _ in host)
    span1 = max(b for _, _, b in host)
    ops = sorted((max(a, span0), min(b, span1)) for _, a, b in device
                 if b > span0 and a < span1)
    out, cursor = [], span0
    for a, b in ops:
        if a > cursor:
            out.append((cursor, a))
        cursor = max(cursor, b)
    if span1 > cursor:
        out.append((cursor, span1))
    return out


def segments(spans: List[tuple]) -> tuple:
    """For one thread's properly nested spans (name, t0, t1): the times at
    which its innermost open span changes, and that span's name from each
    ("" where none is open)."""
    ev = []
    for name, t0, t1 in spans:
        if t1 > t0:
            # at one time, closes first; of two opens, the outer first
            ev.append((t0, 1, -t1, name))
            ev.append((t1, 0, 0, name))
    ev.sort()
    starts: List[float] = []
    names: List[str] = []
    stack: List[str] = []
    for i, (t, opens, _, name) in enumerate(ev):
        if opens:
            stack.append(name)
        else:
            stack.pop()
        if i + 1 == len(ev) or ev[i + 1][0] != t:
            starts.append(t)
            names.append(stack[-1] if stack else "")
    return starts, names


def pieces(seg: tuple, a: float, b: float):
    """(name, us) of each stretch of [a, b) over which one span was the
    innermost open, from `segments`' result ("" where none was)."""
    starts, names = seg
    i = bisect.bisect_right(starts, a) - 1
    t = a
    while t < b:
        end = starts[i + 1] if i + 1 < len(starts) else b
        end = min(end, b)
        if end > t:
            yield (names[i] if i >= 0 else ""), end - t
        t, i = end, i + 1


def idle_by_span(gap_list: List[tuple], engine: List[tuple],
                 arms: List[List[tuple]], n_arm: int) -> tuple:
    """({span: idle s}: each gap split over time by the engine thread's
    innermost span; {span: idle s}: the part in dpu.wait split again over
    time by each of n_arm Arm cores' innermost span, a core's share
    1 / n_arm). Times in us; `arms` holds the spans of the Arm cores that
    recorded any, the others are idle."""
    eng = segments(engine)
    arm_segs = [segments(a) for a in arms]
    by: Dict[str, float] = {}
    in_wait: Dict[str, float] = {}

    def add(table, name, us):
        table[name] = table.get(name, 0.0) + us / 1e6

    for a, b in gap_list:
        t = a
        for name, us in pieces(eng, a, b):
            add(by, name or "no_span", us)
            if name == WAIT and n_arm:
                for seg in arm_segs:
                    for n, u in pieces(seg, t, t + us):
                        add(in_wait, n or "arm_idle", u / n_arm)
                add(in_wait, "arm_idle",
                    us * (n_arm - len(arm_segs)) / n_arm)
            t += us
    return by, in_wait


def _union_len(parts: List[tuple]) -> float:
    total, end = 0.0, None
    for a, b in sorted(parts):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _children(spans: list) -> Dict[int, list]:
    """The spans by their parent's id."""
    out: Dict[int, list] = {}
    for s in spans:
        out.setdefault(s.parent, []).append(s)
    return out


def span_table(spans: list, children: Dict[int, list]) -> Dict[str, dict]:
    """Per name: count, total_s, self_s (its time less the union of its
    children's within it), mean_ms, p95_ms; cpu_share where the spans
    carry CPU time. Spans as the tracer's, times in ns."""
    from portbench.stats import percentile
    groups: Dict[str, list] = {}
    for s in spans:
        groups.setdefault(s.name, []).append(s)
    out = {}
    for name, group in sorted(groups.items()):
        walls = [(s.t1 - s.t0) / 1e9 for s in group]
        own = 0.0
        for s in group:
            kids = [(max(c.t0, s.t0), min(c.t1, s.t1))
                    for c in children.get(s.id, ()) if c.t1 > s.t0
                    and c.t0 < s.t1]
            own += (s.t1 - s.t0 - _union_len(kids)) / 1e9
        row = {"count": len(group), "total_s": sum(walls), "self_s": own,
               "mean_ms": 1e3 * sum(walls) / len(group),
               "p95_ms": percentile([1e3 * w for w in walls], 95)}
        cpu = [s.cpu_ns for s in group if s.cpu_ns is not None]
        if cpu and sum(walls) > 0:
            row["cpu_share"] = sum(cpu) / 1e9 / sum(walls)
        out[name] = row
    return out


def _request_times(spans: list, children: Dict[int, list]) -> list:
    """[rid, first token s, last token s] after engine.wave's start."""
    wave = next((s for s in spans if s.name == "engine.wave"), None)
    if wave is None:
        return []

    def kids(s, name):
        return sorted((c for c in children.get(s.id, ()) if c.name == name),
                      key=lambda c: c.t0)

    prefill = kids(wave, "engine.prefill")
    if not prefill:
        return []
    first = kids(prefill[0], "prefill.token_read")[0].t1
    reads = [first] + [kids(step, "decode.token_read")[0].t1
                       for step in kids(wave, "decode.step")]
    return [[rid, (first - wave.t0) / 1e9,
             (reads[min(new, len(reads)) - 1] - wave.t0) / 1e9]
            for rid, new in zip(wave.attrs["rids"], wave.attrs["new"])]


def summarize_spans(spans: list, clock: Dict[str, int], device: List[tuple],
                    host: List[tuple], n_arm: int) -> dict:
    """The program part of the summary (the keys the module's docstring
    lists) from the tracer's spans, its clock, and the traced wave's
    device operations and host phases (name, start_us, end_us) on the
    profiler's clock."""
    span0 = min(a for _, a, _ in host)
    span1 = max(b for _, _, b in host)
    from repro_torch.common.tracing import to_trace_clock
    base = round(span0 * 1e3)

    def us(t_ns):               # a perf_counter_ns time, us after span0
        return (to_trace_clock(t_ns, clock) - base) / 1e3

    children = _children(spans)
    width = span1 - span0
    inside = [s for s in spans if us(s.t0) >= 0 and us(s.t1) <= width]
    wave = next((s for s in spans if s.name == "engine.wave"), None)
    engine_tid = wave.tid if wave is not None else None
    by_tid: Dict[int, list] = {}
    for s in spans:
        if not s.interval:
            by_tid.setdefault(s.tid, []).append((s.name, us(s.t0),
                                                 us(s.t1)))
    arm_tids = sorted({s.tid for s in spans if s.name == ARM_OP})
    gap_list = [(a - span0, b - span0) for a, b in gaps(device, host)]
    by, in_wait = idle_by_span(gap_list, by_tid.get(engine_tid, []),
                               [by_tid[t] for t in arm_tids], n_arm)
    phases = {n: (a - span0, b - span0) for n, a, b in host}
    checks = {}
    for name, phase in CHECKS:
        if phase not in phases:
            continue
        a, b = phases[phase]
        over = [max(a - us(s.t0), us(s.t1) - b, 0.0) for s in inside
                if s.name == name]
        checks[f"{name} in {phase}"] = {
            "checked": len(over), "outside": sum(o > 0 for o in over),
            "max_overhang_us": max(over, default=0.0)}
    return {"spans": span_table(inside, children), "idle_by_span": by,
            "idle_in_dpu_wait": in_wait, "inside": checks,
            "requests": _request_times(spans, children),
            "arm_cores": n_arm, "spans_recorded": len(spans),
            "clock_drift_us": clock["drift_ns"] / 1e3}


def program_wave(eng, store, traffic, steps: int = 32,
                 wave=None) -> Optional[dict]:
    """One wave traced by `wave` (`trace.traced_wave` unless given), with
    the program's tracer on: its summary and the program's (above), or
    None for a program without the tracer."""
    try:
        from repro_torch.common import tracing
    except ImportError:
        return None
    from portbench import trace
    wave = wave or trace.traced_wave
    raw = []
    parse = trace._events

    def keep(prof):
        raw.append(parse(prof))
        return raw[-1]

    dpu = getattr(store.client, "dpu", None)
    n_arm = dpu.n_cores if dpu else 0
    tracing.collect()
    trace._events = keep
    tracing.enable()
    try:
        out = wave(eng, store, traffic, steps)
    finally:
        clock = tracing.disable()
        trace._events = parse
    spans = tracing.collect()
    device, host = raw[-1]
    for k in ("ops_by_name", "ops_by_phase"):
        out.pop(k, None)
    out.update(summarize_spans(spans, clock, device, host, n_arm))
    return out


def bare_wave(eng, store, traffic, steps: int = 32) -> Optional[dict]:
    """One wave with the program's tracer on and no profiler, whose cost
    on every CUDA call (a graph replay's launch most) is then not in the
    spans: their table over the stretch a traced wave covers (from the
    reads to the end of decode step `steps`), that stretch's host seconds
    (`host_s`), the wave's reads' (`reads_s`) and `requests`. None for a
    program without the tracer."""
    try:
        from repro_torch.common import tracing
    except ImportError:
        return None
    from portbench.serve import run_wave
    tracing.collect()
    tracing.enable()
    t0 = time.perf_counter_ns()
    try:
        wave, _ = run_wave(eng, store, traffic, t0 / 1e9)
    finally:
        tracing.disable()
    spans = tracing.collect()
    children = _children(spans)
    steps_at = sorted(s.t0 for s in spans if s.name == "decode.step")
    end = (steps_at[steps] if len(steps_at) > steps
           else max(s.t1 for s in spans))
    inside = [s for s in spans if s.t0 >= t0 and s.t1 <= end]
    return {"spans": span_table(inside, children),
            "host_s": (end - t0) / 1e9,
            "reads_s": wave["start"] - wave["reads_start"],
            "requests": _request_times(spans, children)}


def bare_table(rec: dict) -> dict:
    """The span table of the record's wave without the profiler, or {}."""
    return ((rec.get("trace") or {}).get(BARE) or {}).get("spans") or {}


def read_metrics(trace: Dict[str, Optional[dict]]) -> Dict[str, object]:
    """PROGRAM_METRICS read from a record whose trace holds `trace`."""
    from portbench.spec import reader
    rec = {"trace": trace}
    return {m: reader(m)(rec) for m in PROGRAM_METRICS}


@contextlib.contextmanager
def second_wave():
    """Inside, `run.run_cell`'s traced wave (it looks `traced_wave` up at
    its call) is followed by `program_wave` and `bare_wave`, whose
    summaries go under the first's as `program` and `program_no_profiler`.
    Yields a dict that keeps them under those names too.

    A stopgap while `run.py` does not call the two waves itself: it and
    `program_wave`'s swap of `trace._events` go, with `main`, once
    `traced_wave` takes an argument that hands back its raw events and
    `run_cell` calls `program_wave` and `bare_wave` after it."""
    from portbench import trace
    first = trace.traced_wave
    kept: Dict[str, Optional[dict]] = {}

    def both(eng, store, traffic, steps=32):
        out = first(eng, store, traffic, steps)
        out["program"] = kept["program"] = program_wave(
            eng, store, traffic, steps, wave=first)
        out[BARE] = kept[BARE] = bare_wave(eng, store, traffic, steps)
        return out

    trace.traced_wave = both
    try:
        yield kept
    finally:
        trace.traced_wave = first


def main(argv=None) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench import run
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--trace" in argv:
        i = argv.index("--trace")
        del argv[i:i + 2]
    with second_wave() as kept:
        rc = run.main(argv + ["--trace", "1"])
    print("portbench spans: " + json.dumps(read_metrics(kept)))
    return rc


if __name__ == "__main__":
    sys.exit(main())
