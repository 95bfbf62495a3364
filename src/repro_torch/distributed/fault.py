"""Fault handling for the training runtime.

Three layers, matching what "runnable on 1000+ nodes" requires:

  * storage faults — the object store replicates extents and rebuilds from
    surviving replicas (core.object_store); FailureInjector drives device
    kills/recoveries and silent corruption for tests and drills,
  * stragglers — StragglerMonitor tracks per-rank step times against a
    rolling median; the loader's hedged reads act on the storage side, and
    the trainer surfaces flagged ranks for scheduler action,
  * membership — ElasticMembership turns join/leave events into new
    (dp_rank, dp_size) assignments and drives loader resharding.
"""
from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence


class StragglerMonitor:
    """Flags ranks whose recent step times exceed factor x rolling median."""

    def __init__(self, window: int = 16, factor: float = 2.0):
        self.window = window
        self.factor = factor
        self._t: Dict[int, deque] = defaultdict(
            lambda: deque(maxlen=window))

    def record(self, rank: int, step_time_s: float) -> None:
        self._t[rank].append(step_time_s)

    def medians(self) -> Dict[int, float]:
        out = {}
        for r, dq in self._t.items():
            s = sorted(dq)
            out[r] = s[len(s) // 2] if s else 0.0
        return out

    def stragglers(self) -> List[int]:
        med = self.medians()
        if not med:
            return []
        vals = sorted(med.values())
        global_med = vals[len(vals) // 2]
        if global_med <= 0:
            return []
        return sorted(r for r, m in med.items()
                      if m > self.factor * global_med)


class FailureInjector:
    """Drives storage-target failures against an ObjectStore (drills)."""

    def __init__(self, store):
        self.store = store
        self.events: List[str] = []

    def kill(self, device_name: str) -> None:
        self.store.fail_device(device_name)
        self.events.append(f"kill:{device_name}")

    def recover(self, device_name: str) -> None:
        d = self.store.device(device_name)
        if d:
            d.recover()
        self.events.append(f"recover:{device_name}")

    def corrupt_block(self, device_name: str, which: int = 0) -> bool:
        """Flip a byte in one stored block (silent corruption). The e2e
        checksum must route the read to a clean replica. Donated (not yet
        written-back) blocks are flushed first so the corruption lands in
        the device's private store, never in a live staging-ring slot."""
        d = self.store.device(device_name)
        if d is None or not d._blocks:
            return False
        d.writeback()
        keys = sorted(d._blocks)
        key = keys[which % len(keys)]
        raw = bytearray(d._blocks[key])
        raw[0] ^= 0xFF
        d._blocks[key] = bytes(raw)
        self.events.append(f"corrupt:{device_name}:{key}")
        return True

    def rebuild(self, device_name: str) -> int:
        moved = self.store.rebuild(device_name)
        self.events.append(f"rebuild:{device_name}:{moved}")
        return moved


@dataclass
class Member:
    rank: int
    alive: bool = True


class ElasticMembership:
    """Tracks the data-parallel worker set; computes stable rank
    assignments after joins/leaves and notifies subscribers (loaders)."""

    def __init__(self, initial: int):
        self._members: List[str] = [f"host{i}" for i in range(initial)]
        self._subs: List[Callable[[Dict[str, int], int], None]] = []
        self.generation = 0

    def subscribe(self, fn: Callable[[Dict[str, int], int], None]) -> None:
        self._subs.append(fn)

    def _notify(self) -> None:
        self.generation += 1
        asg = self.assignment()
        for fn in self._subs:
            fn(asg, len(self._members))

    def assignment(self) -> Dict[str, int]:
        """host -> dp_rank, stable order (sorted by name)."""
        return {h: i for i, h in enumerate(sorted(self._members))}

    def join(self, host: str) -> None:
        if host not in self._members:
            self._members.append(host)
            self._notify()

    def leave(self, host: str) -> None:
        if host in self._members:
            self._members.remove(host)
            self._notify()

    @property
    def size(self) -> int:
        return len(self._members)
