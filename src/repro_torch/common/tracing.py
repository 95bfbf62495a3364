"""The port's span tracer: named host intervals at the layer boundaries
where the program waits, kept in memory and off by default.

    from repro_torch.common import tracing

    tracing.enable()
    ...                                # the work to trace
    clock = tracing.disable()          # {"offset_ns": ..., "drift_ns": ...}
    spans = tracing.collect()          # every span since the last collect
    t_us = tracing.to_trace_clock(spans[0].t0, clock) / 1e3

Call sites write `with tracing.span("ec.gather"): ...`. With tracing off
that is one check of the module's `ON` flag and the one shared no-op
context: nothing is allocated and no lock is taken. A site that passes
attributes checks `tracing.ON` itself first (`span(...) if tracing.ON
else tracing.NOOP`), so that their keyword dict is not built either. Nothing turns tracing
on but `enable()`: no environment variable, no exporter, no file. A
caller (a benchmark, a test, an operator at a console) enables it around
the work it wants to see and reads the spans back with `collect()`.

A span (`Span`) holds its name, its id, the id of the span that was open
on the same thread when it opened (its parent, 0 for none), a trace id
that one request's spans share (given at the span, or inherited from the
parent), its thread, its start and end on `time.perf_counter_ns()`,
optionally the thread's CPU time over it (`time.thread_time_ns()`: wall
minus CPU is the time the thread waited, on the interpreter lock or a
lock or queue), and its attributes. Work caused on another thread passes
the trace id over (`current_trace()`); a wait whose start was stamped
(`stamp()`) on another thread is recorded as an `interval`.

Spans go to a list per thread, each registered once under a lock, so
recording takes no lock. The profiler's host events carry the wall clock
(`time.time_ns()`); `enable()` and `disable()` each read the pair (wall,
perf_counter), and `to_trace_clock` maps a span's time onto the wall clock
with the pairs' mean offset. `disable()` reports the drift between them.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

# read by the call sites; set only by enable() and disable()
ON = False


class Span(NamedTuple):
    name: str
    id: int
    parent: int                 # the enclosing span on this thread, or 0
    trace: Any                  # shared by one request's spans, or None
    tid: int                    # threading.get_ident() of the recorder
    t0: int                     # perf_counter_ns
    t1: int
    cpu_ns: Optional[int]       # thread CPU time, when asked for
    interval: bool              # a wait stamped across threads
    attrs: Dict[str, Any]


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()

_ids = itertools.count(1)
_lock = threading.Lock()
_lists: List[tuple] = []        # (thread, its finished spans)
_local = threading.local()
_pairs: List[int] = []          # time_ns - perf_counter_ns at enable and
                                # at disable


class _Thread:
    __slots__ = ("stack", "done")

    def __init__(self):
        self.stack: List["_Open"] = []
        self.done: List[Span] = []


def _state() -> _Thread:
    st = getattr(_local, "st", None)
    if st is None:
        st = _local.st = _Thread()
        with _lock:
            _lists.append((threading.current_thread(), st.done))
    return st


class _Open:
    __slots__ = ("name", "id", "parent", "trace", "cpu", "cpu0", "t0",
                 "attrs", "st")

    def __init__(self, name, trace, cpu, attrs):
        self.name, self.trace, self.cpu, self.attrs = name, trace, cpu, attrs

    def __enter__(self):
        st = self.st = _state()
        top = st.stack[-1] if st.stack else None
        self.id = next(_ids)
        self.parent = top.id if top is not None else 0
        if self.trace is None and top is not None:
            self.trace = top.trace
        st.stack.append(self)
        if self.cpu:
            self.cpu0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        cpu = time.thread_time_ns() - self.cpu0 if self.cpu else None
        st = self.st
        st.stack.pop()
        st.done.append(Span(self.name, self.id, self.parent, self.trace,
                            threading.get_ident(), self.t0, t1, cpu, False,
                            self.attrs))
        return False


def span(name: str, trace_id: Any = None, cpu: bool = False, **attrs):
    """A context that records `name` over its body; `trace_id` defaults
    to the enclosing span's, `cpu=True` adds the thread's CPU time. With
    tracing off, the shared no-op."""
    if not ON:
        return NOOP
    return _Open(name, trace_id, cpu, attrs)


def interval(name: str, t0_ns: int, t1_ns: int, trace_id: Any,
             **attrs) -> None:
    """Record a wait from `t0_ns` (stamped on another thread, on
    perf_counter_ns) to `t1_ns`, under this thread's innermost span."""
    if not ON:
        return
    st = _state()
    parent = st.stack[-1].id if st.stack else 0
    st.done.append(Span(name, next(_ids), parent, trace_id,
                        threading.get_ident(), t0_ns, t1_ns, None, True,
                        attrs))


def stamp() -> int:
    """perf_counter_ns() with tracing on, else 0: the time an object that
    crosses threads (an SQE, a CQE) carries for a later `interval`."""
    return time.perf_counter_ns() if ON else 0


def current_trace() -> Any:
    """The trace id of this thread's innermost open span, or None: what
    work handed to another thread carries over."""
    if not ON:
        return None
    stack = getattr(_local, "st", None)
    return stack.stack[-1].trace if stack is not None and stack.stack \
        else None


def _pair() -> int:
    """time_ns - perf_counter_ns, the wall clock read between two
    perf_counter reads."""
    a = time.perf_counter_ns()
    w = time.time_ns()
    b = time.perf_counter_ns()
    return w - (a + b) // 2


def enable() -> None:
    """Turn tracing on and read the clock pair."""
    global ON
    _pairs[:] = [_pair()]
    ON = True


def disable() -> Dict[str, int]:
    """Turn tracing off, read the clock pair again, and return the clock:
    the mean offset from perf_counter_ns to time_ns and the drift between
    the two readings."""
    global ON
    ON = False
    if _pairs:
        _pairs[1:] = [_pair()]
    return _clock()


def _clock() -> Dict[str, int]:
    """{"offset_ns", "drift_ns"} of the last enable/disable pair."""
    if not _pairs:
        return {"offset_ns": _pair(), "drift_ns": 0}
    return {"offset_ns": sum(_pairs) // len(_pairs),
            "drift_ns": _pairs[-1] - _pairs[0]}


def to_trace_clock(t_ns: int, clock: Optional[Dict[str, int]] = None) -> int:
    """A span's perf_counter_ns time on the wall clock (time_ns), which the
    profiler's host and device events carry: through `clock` (as
    `disable()` returns it), else the last enable/disable pair."""
    return t_ns + (clock or _clock())["offset_ns"]


def collect() -> List[Span]:
    """Every finished span since the last collect, from every thread;
    the lists of threads that have ended are dropped."""
    out: List[Span] = []
    with _lock:
        keep = []
        for thread, done in _lists:
            n = len(done)
            out.extend(done[:n])
            del done[:n]
            if thread.is_alive() or done:
                keep.append((thread, done))
        _lists[:] = keep
    return out
