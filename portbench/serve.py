"""The timed path: the program's `BatchedEngine` fed by the store, driven
as a closed loop of `batch` clients.

Each client holds one request. When a wave returns, every client sends
its next request at once: its prompt is read from the store, and the
wave starts when all prompts are in, so every wave is full. The window
opens as the first wave's reads start and closes `seconds` later; no
wave starts after it closes, and the one in flight runs to its end.

The engine is the program's, with the host clock read as each step
starts (`timed_engine`): step k's tokens are read (run_wave's
`.tolist()`) just before step k + 1 starts, the last step's at
run_wave's return. Nothing else of it changes.
"""
from __future__ import annotations

import time
from typing import List


def timed_engine(*args, **kw):
    """A BatchedEngine whose prefill and decode calls note the host clock
    in `.marks` and call `.on_step(kind, index)` first, if set."""
    from repro_torch.launch.serve import BatchedEngine

    class TimedEngine(BatchedEngine):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.marks: List[tuple] = []
            self.on_step = None

        def _note(self, kind: str) -> None:
            self.marks.append((kind, time.perf_counter()))
            if self.on_step is not None:
                self.on_step(kind, len(self.marks) - 1)

        def _run_prefill(self, inputs) -> None:
            self._note("prefill")
            super()._run_prefill(inputs)

        def _run_decode(self) -> None:
            self._note("decode")
            super()._run_decode()

    return TimedEngine(*args, **kw)


def _counters(eng) -> dict:
    return {"prefill_s": eng.prefill_s, "decode_s": eng.decode_s,
            "steps": eng.steps, "slot_steps": eng.slot_steps,
            "active_slot_steps": eng.active_slot_steps}


def run_wave(eng, store, traffic, t0: float) -> tuple:
    """One closed-loop wave: the clients' reads, then the engine's wave.
    Returns (the wave's record, its requests' records), host times in
    seconds after t0."""
    from repro_torch.launch.serve import Request
    reqs = traffic.wave()
    got = store.read(reqs)
    served, recs = [], []
    for r, g in zip(reqs, got):
        rec = {"rid": r.rid, "items": r.items, "max_new": r.max_new,
               "send": g["send"] - t0, "read_done": g["read_done"] - t0}
        p = g.get("prompt")
        if p is None or p.shape != (traffic.prompt_len,):
            rec["error"] = g.get("error", f"prompt of shape "
                                 f"{None if p is None else p.shape}")
        else:
            rec["prompt"] = p
            served.append((rec, Request(r.rid, p, r.max_new)))
        recs.append(rec)
    if not served:
        raise RuntimeError("every read of a wave failed")
    before = _counters(eng)
    eng.marks = []
    start = time.perf_counter()
    eng.run_wave([q for _, q in served])
    end = time.perf_counter()
    after = _counters(eng)
    delta = {k: after[k] - before[k] for k in after}
    decode_marks = [t for kind, t in eng.marks if kind == "decode"]
    # the prefill's tokens are read before the first decode step starts,
    # step k's before step k + 1's
    token_times = [t - t0 for t in decode_marks] + [end - t0]
    active = [len(served)] + [sum(q.max_new >= k + 1 for _, q in served)
                              for k in range(1, len(token_times))]
    for rec, q in served:
        rec["first_token"] = start - t0 + delta["prefill_s"]
        rec["reply"] = end - t0
        rec["out"] = list(q.out)
    wave = {"start": start - t0, "end": end - t0,
            "reads_start": min(r["send"] for r in recs),
            "batch": eng.batch, "requests": len(served),
            "prompt_len": traffic.prompt_len,
            "token_times": token_times, "active": active, **delta}
    return wave, recs


def serve_window(eng, store, traffic, seconds: float) -> dict:
    """Closed-loop waves for `seconds`: the window's record."""
    waves, reqs = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        w, r = run_wave(eng, store, traffic, t0)
        waves.append(w)
        reqs.extend(r)
    return {"t0": t0, "seconds": float(seconds), "waves": waves,
            "requests": reqs, "after_s": time.perf_counter() - t0}


WARM_S = 10.0


def warm_up(eng, store, traffic_warm, seconds: float = WARM_S) -> int:
    """Waves of the cell's traffic (its shapes: the first captures the
    prefill and the decode step) until `seconds` have passed, at least
    one: with a shorter warm-up the window's first waves decoded up to 4%
    slower than its later ones (host-side: the traced device time of a
    step is the later waves'). Returns the waves run."""
    t = time.perf_counter()
    n = 0
    while n == 0 or time.perf_counter() - t < seconds:
        run_wave(eng, store, traffic_warm, t)
        n += 1
    return n


def replays(eng) -> dict:
    return {"prefill": eng.prefill_step.calls, "decode": eng.decode_step.calls}
