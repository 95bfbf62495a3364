"""Deterministic fault injection + timeout policy for the storage fleet.

Two pieces, both injectable and both optional (every hook is a no-op when
no injector / default policy is wired):

  * FaultInjector — a seeded schedule of (op_match, fault, when) rules
    threaded through every layer boundary of the ROS2 stack: transport SG
    ops (error / delay / partial transfer), engine fetch/commit (target
    crash mid-op, post-ack replica failure via media faults), media
    reads/writes (I/O error), control-plane RPCs (drop / delay),
    capability checks (premature rkey expiry), and pool-map pushes (lost
    recall).  Every injection AND every recovery path taken is counted,
    and the roll-up rides `data_path_counters()["faults"]` so a soak run
    can prove each fault class both fired and recovered.

  * Timeouts — the one policy object behind every data-path deadline
    (staging-ring acquire, replica-commit quorum/drain, DPU completion
    waits, and the router's per-op dispatch deadline + retry budget).
    Timeout errors are raised as OpTimeout carrying (op, target, elapsed)
    instead of a bare TimeoutError string.

The module is deliberately import-light (stdlib only) so every core
module can import it without cycles.
"""
from __future__ import annotations

import fnmatch
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple, Union


# ---------------------------------------------------------------------------
# timeout policy


@dataclass(frozen=True)
class Timeouts:
    """Single source of truth for data-path deadlines.

    One instance is threaded from ROS2Client into the staging ring,
    replica-commit waits, DPU completion waits, and the cluster router.
    Tests inject a tightened copy instead of monkeypatching five
    scattered ``timeout=120.0`` defaults.
    """

    staging_acquire_s: float = 120.0    # _StagingRing.acquire
    quorum_s: float = 120.0             # _PendingCommit.wait_quorum
    drain_s: float = 120.0              # _PendingCommit.wait_complete
    dpu_wait_s: float = 120.0           # DPURuntime.wait_all / _dpu_call
    dpu_tag_s: float = 30.0             # DPURuntime.wait_tag
    op_deadline_s: float = 120.0        # _ClusterRouter._dispatch per-op
    poll_interval_s: float = 0.05       # bounded re-check polls (cv/cq/queue)
    thread_join_s: float = 5.0          # service-thread join on stop/close
    retry_budget: int = 3               # dispatch re-route attempts
    retry_backoff_s: float = 0.05       # base backoff (2nd retry onward)
    retry_backoff_cap_s: float = 1.0    # capped exponential ceiling
    retry_jitter_seed: int = 0          # full-jitter stream (seeded, stateless)

    def backoff_cap(self, attempt: int) -> float:
        """Capped-exponential envelope for dispatch retry `attempt` (1-based).

        The first retry is free — a map refresh, not a wait — so backoff
        only kicks in from the second retry onward.
        """
        if attempt <= 1:
            return 0.0
        return min(self.retry_backoff_s * (2.0 ** (attempt - 2)),
                   self.retry_backoff_cap_s)

    def backoff(self, attempt: int, salt: int = 0) -> float:
        """Full-jitter sleep in (0, backoff_cap(attempt)] for a retry.

        After a correlated fault (a target dropping mid-burst) every client
        retries the same target on the same schedule; deterministic capped
        exponential turns that into synchronized retry storms.  AWS-style
        full jitter draws uniformly under the envelope instead, but from a
        seeded stateless stream — an FNV-1a hash of (seed, attempt, salt) —
        so soak runs stay replayable and the dataclass stays frozen.
        Callers salt with the failed target id so co-retrying streams
        decorrelate from each other, not just from their own history.
        """
        cap = self.backoff_cap(attempt)
        if cap <= 0.0:
            return 0.0
        h = 0xCBF29CE484222325
        for word in (self.retry_jitter_seed, attempt, salt):
            h ^= word & 0xFFFFFFFFFFFFFFFF
            h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
        u = (h >> 11) / float(1 << 53)          # uniform [0, 1)
        return cap * (1.0 - u)                  # (0, cap] — never a zero wait


DEFAULT_TIMEOUTS = Timeouts()


class OpTimeout(TimeoutError):
    """A deadline expiry that knows which op, on which target, after how
    long — instead of ``TimeoutError("staging ring exhausted")``."""

    def __init__(self, op: str, target: Optional[str] = None,
                 elapsed_s: float = 0.0, detail: str = ""):
        self.op = op
        self.target = target
        self.elapsed_s = elapsed_s
        self.detail = detail
        where = f" on {target}" if target is not None else ""
        tail = f": {detail}" if detail else ""
        super().__init__(
            f"{op}{where} timed out after {elapsed_s:.2f}s{tail}")


# ---------------------------------------------------------------------------
# fault injection


class InjectedFault(Exception):
    """Marker base so hardening code can tell an injected anomaly from a
    genuine one where the distinction matters (it rarely should)."""


class InjectedTransientError(InjectedFault, IOError):
    """A transient transport/media anomaly (link blip, partial transfer).

    Raised by transport SG hooks; the initiator-side hardening retries
    the op once, RC-QP-retransmit style.
    """


@dataclass
class Fault:
    """One fault spec: what happens when a rule fires.

    kind:
      error    — raise `exc` (transport/media/engine hooks)
      partial  — transfer a prefix then raise (transport SG hooks)
      crash    — target crash mid-op (engine hook raises TargetDownError)
      drop     — swallow the op (control RPC returns an error envelope,
                 pool-map push skips the recall)
      delay    — sleep `delay_s`, then proceed normally
      expire   — prematurely expire a capability (rkey hook)
    """

    kind: str = "error"
    exc: Optional[Callable[[], BaseException]] = None
    delay_s: float = 0.0
    action: Optional[Callable[[], None]] = None   # arbitrary side effect

    def make_exc(self, op: str) -> BaseException:
        if self.exc is not None:
            return self.exc()
        return InjectedTransientError(f"injected {self.kind} at {op}")


# `when` forms: int n (fire on the nth matching call, once), (a, b) tuple
# (fire on matches a..b inclusive), float p (seeded Bernoulli per match),
# or callable(match_count) -> bool.
When = Union[int, Tuple[int, int], float, Callable[[int], bool]]


@dataclass
class _Rule:
    op_match: str
    fault: Fault
    when: When
    matches: int = 0
    fired: int = 0

    def matches_op(self, op: str) -> bool:
        return fnmatch.fnmatchcase(op, self.op_match)

    def should_fire(self, rng: random.Random) -> bool:
        self.matches += 1
        w = self.when
        if isinstance(w, bool):          # guard: bool is an int subclass
            return w
        if isinstance(w, int):
            return self.matches == w
        if isinstance(w, tuple):
            return w[0] <= self.matches <= w[1]
        if isinstance(w, float):
            return rng.random() < w
        return bool(w(self.matches))


class FaultInjector:
    """Seeded, deterministic fault schedule for the storage stack.

    schedule: iterable of (op_match, fault, when) rules.  op_match is an
    fnmatch glob over hook-point names ("transport.write_sg",
    "engine.crash", "media.write", "control.rpc.get_pool_map",
    "cap.expire", "map.push", ...).  Rules are evaluated in order; the
    first firing rule wins for a given call.

    Determinism: each rule keeps its own match counter and the injector
    owns one seeded RNG, so a given (schedule, seed, call sequence)
    always injects the same faults.  Probability rules are only as
    deterministic as the caller's thread interleaving — soak tests use
    count/range rules for must-fire classes and probabilities for volume.
    """

    def __init__(self, schedule: Sequence[Tuple[str, Fault, When]] = (),
                 seed: int = 0):
        self._rules = [_Rule(m, f, w) for m, f, w in schedule]
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected: Dict[str, int] = {}
        self.injected_by_kind: Dict[str, int] = {}
        self.recovered: Dict[str, int] = {}

    def arm(self, op_match: str, fault: Fault, when: When) -> None:
        with self._lock:
            self._rules.append(_Rule(op_match, fault, when))

    # -- hook API -----------------------------------------------------------

    def pick(self, op: str, **ctx) -> Optional[Fault]:
        """Evaluate the schedule for one call at hook point `op`.

        Returns the firing Fault (already counted, its delay slept and
        its action run) or None.  Hooks that can express the fault
        in-band (drop, partial, expire) interpret the returned spec;
        hooks that just need an exception call `fire` instead.
        """
        fault = None
        with self._lock:
            for r in self._rules:
                if not r.matches_op(op):
                    continue
                if r.should_fire(self._rng):
                    r.fired += 1
                    fault = r.fault
                    self.injected[op] = self.injected.get(op, 0) + 1
                    self.injected_by_kind[fault.kind] = \
                        self.injected_by_kind.get(fault.kind, 0) + 1
                    break
        if fault is not None:
            if fault.delay_s > 0.0:
                time.sleep(fault.delay_s)
            if fault.action is not None:
                fault.action()
        return fault

    def fire(self, op: str, **ctx) -> None:
        """pick(), and raise the fault's exception for error-like kinds."""
        f = self.pick(op, **ctx)
        if f is not None and f.kind not in ("delay",):
            raise f.make_exc(op)

    def note_recovery(self, path: str) -> None:
        """Record that a hardened recovery path ran to completion."""
        with self._lock:
            self.recovered[path] = self.recovered.get(path, 0) + 1

    # -- reporting ----------------------------------------------------------

    def counters(self) -> Dict[str, object]:
        with self._lock:
            return {
                "injected": dict(self.injected),
                "injected_by_kind": dict(self.injected_by_kind),
                "recovered": dict(self.recovered),
                "total_injected": sum(self.injected.values()),
                "total_recovered": sum(self.recovered.values()),
            }


def note_recovery(injector: Optional[FaultInjector], path: str) -> None:
    """Guarded helper: count a recovery iff an injector is wired."""
    if injector is not None:
        injector.note_recovery(path)
