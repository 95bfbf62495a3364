"""Client-side leased metadata/capability cache (NFSv4-style delegation).

The DPU-resident DFS client pays a full control-plane round-trip for every
`lookup`/`stat`/`grant_rkey` unless something amortizes it. This cache
holds:

  * namespace entries (`lookup`/`stat` results) under the server-issued
    lease TTL — warm `open` costs ZERO round-trips;
  * rkey capabilities with their expiry, renewed BEFORE they lapse (an
    expired rkey mid-run is a hard data-plane fault, not a soft miss).

Lease discipline: a lease is treated as dead `skew_margin * ttl` early —
client and server clocks may disagree, and serving a stale entry because
"our" clock said the lease had 200 ms left is exactly the bug the margin
prevents. The server pushes invalidations for namespace mutations made by
OTHER sessions (ControlPlane._notify), so delegation never trades
round-trips for staleness. `clock` is injectable for deterministic tests.

Renewal runs wherever the client runs: `start_renewal()` spawns a plain
thread (host mode); in DPU mode the runtime's housekeeping service calls
`renew_due()` from an Arm core instead (smartnic.DPURuntime).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.core.faults import DEFAULT_TIMEOUTS

DEFAULT_SKEW_MARGIN = 0.25    # fraction of the TTL surrendered to skew
RENEW_INTERVAL_S = 1.0


@dataclass
class MetaCacheStats:
    lookup_hits: int = 0          # opens/stats served with 0 round-trips
    lookup_misses: int = 0
    expiries: int = 0             # entries dropped because the lease lapsed
    invalidations: int = 0        # server-pushed lease recalls honored
    rkey_renewals: int = 0        # renew_rkey RPCs issued before expiry


class MetadataCache:
    """One per (client session); registers itself on the control plane's
    push channel so other sessions' mutations recall our leases."""

    def __init__(self, control, session_id: int,
                 skew_margin: float = DEFAULT_SKEW_MARGIN,
                 clock: Callable[[], float] = time.monotonic):
        self.cp = control
        self.session_id = session_id
        self.skew = float(skew_margin)
        self.clock = clock
        # path -> (entry dict, expires_at, ttl)
        self._meta: Dict[str, Tuple[Dict[str, Any], float, float]] = {}
        # token -> {"expires_at", "ttl_s"}
        self._rkeys: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()
        self._renew_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats = MetaCacheStats()
        control.subscribe(session_id, self.invalidate)

    def _usable(self, expires_at: float, ttl: float) -> bool:
        return self.clock() < expires_at - self.skew * ttl

    # -- namespace leases ----------------------------------------------------
    def put_meta(self, path: str, entry: Dict[str, Any],
                 ttl_s: float) -> None:
        with self._lock:
            self._meta[path] = (dict(entry), self.clock() + ttl_s,
                                float(ttl_s))

    def get_meta(self, path: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            hit = self._meta.get(path)
            if hit is None:
                self.stats.lookup_misses += 1
                return None
            entry, expires_at, ttl = hit
            if not self._usable(expires_at, ttl):
                del self._meta[path]
                self.stats.expiries += 1
                self.stats.lookup_misses += 1
                return None
            self.stats.lookup_hits += 1
            return dict(entry)

    def update_meta(self, path: str, **fields) -> None:
        """Patch a cached entry in place (e.g. the locally-delegated size)
        without touching its lease clock."""
        with self._lock:
            hit = self._meta.get(path)
            if hit is not None:
                entry, expires_at, ttl = hit
                entry.update(fields)
                self._meta[path] = (entry, expires_at, ttl)

    def bump_size(self, path: str, size: int) -> None:
        """Raise a cached entry's size high-water mark (write delegation
        keeping our own lease coherent). Stats-free: this is not a lookup."""
        with self._lock:
            hit = self._meta.get(path)
            if hit is not None and hit[0].get("size", 0) < size:
                hit[0]["size"] = size

    def invalidate(self, path: str) -> None:
        """Server-pushed lease recall (or local drop on our own mutation)."""
        with self._lock:
            if self._meta.pop(path, None) is not None:
                self.stats.invalidations += 1

    def clear(self) -> None:
        with self._lock:
            self._meta.clear()

    # -- rkey capability leases ----------------------------------------------
    def put_rkey(self, token: str, ttl_s: float) -> None:
        with self._lock:
            self._rkeys[token] = {"expires_at": self.clock() + ttl_s,
                                  "ttl_s": float(ttl_s)}

    def drop_rkey(self, token: str) -> None:
        with self._lock:
            self._rkeys.pop(token, None)

    def rkey_fresh(self, token: str) -> bool:
        """Cheap (dict get + compare) hot-path check: is this capability
        safely inside its lease, skew margin included?"""
        with self._lock:
            ent = self._rkeys.get(token)
        return ent is not None and self._usable(ent["expires_at"],
                                                ent["ttl_s"])

    def renew_due(self) -> int:
        """Renew every rkey inside its skew margin (one renew_rkey RPC
        each); returns how many renewals were issued. Called by the
        background renewal loop and as the hot path's slow-path fallback."""
        with self._lock:
            due = [(t, e["ttl_s"]) for t, e in self._rkeys.items()
                   if not self._usable(e["expires_at"], e["ttl_s"])]
        renewed = 0
        for token, ttl in due:
            r = self.cp.rpc("renew_rkey", session_id=self.session_id,
                            rkey=token, ttl_s=ttl)
            if r["ok"]:
                with self._lock:
                    self._rkeys[token] = {
                        "expires_at": self.clock() + r["expires_in"],
                        "ttl_s": float(ttl)}
                    self.stats.rkey_renewals += 1
                renewed += 1
            else:                     # revoked/gone: stop renewing it
                self.drop_rkey(token)
        return renewed

    # -- background renewal (host mode; DPU mode uses runtime housekeeping) --
    def start_renewal(self, interval_s: float = RENEW_INTERVAL_S) -> None:
        if self._renew_thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                self.renew_due()

        self._renew_thread = threading.Thread(target=loop,
                                              name="lease-renew",
                                              daemon=True)
        self._renew_thread.start()

    def stop_renewal(self) -> None:
        if self._renew_thread is None:
            return
        self._stop.set()
        self._renew_thread.join(timeout=DEFAULT_TIMEOUTS.thread_join_s)
        self._renew_thread = None
