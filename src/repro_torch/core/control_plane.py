"""Control plane: gRPC-style session/namespace/capability service.

Small, latency-insensitive messages only: session setup, authentication,
mount/open/close, directory ops, capability (rkey) exchange, QoS tokens.
Bulk data NEVER flows here — tests assert control traffic stays tiny
relative to the data plane (the paper's design point).

Round-trip economy: the control plane speaks NFSv4-style COMPOUND —
`rpc("compound", ops=[...])` executes an ordered op list in ONE round-trip,
stopping at the first failure and returning per-op results. A `connect` op
inside a compound establishes the implicit session for the ops after it
(EXCHANGE_ID-style), so a client brings a session up — connect + mount +
grant_rkey — in a single RPC. Namespace reads (`lookup`/`stat`/`create`)
carry a metadata lease TTL the client-side MetadataCache may serve from;
the server pushes invalidations to OTHER sessions' caches on `create`/
`unlink`/`set_size`/`truncate` so delegated entries never go stale, and
`renew_rkey` extends a capability's expiry in place (the data plane keeps
validating expiry on every access — renewal is what makes long runs safe).

Cluster control: when the backing store is a StorageCluster, the
service owns ONE registry per engine target (grant/renew/revoke address
regions and tokens across all of them — region ids are globally unique),
serves the versioned pool map via `get_pool_map` (a compound-friendly op:
session bring-up fetches the map in the same round-trip as connect +
mount + the per-target rkey grants), and subscribes to the map so every
version bump is PUSHED to routed clients lease-recall-style — a client
with a stale map performs one refresh, not a failed op retry loop.
"""
from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.data_plane import AccessError, MemoryRegion, MemoryRegistry
from repro_torch.core.object_store import ObjectStore

META_LEASE_S = 30.0          # default namespace-entry delegation TTL


@dataclass
class Session:
    session_id: int
    tenant: str
    qos_tokens: int = 1 << 20       # ops budget (QoS hook)
    created_at: float = field(default_factory=time.monotonic)


class ControlPlane:
    """Server-side control-plane service. Call via `rpc(method, **payload)`
    to mimic a gRPC channel; every call is counted."""

    def __init__(self, store, registry,
                 tenants: Optional[Dict[str, str]] = None,
                 meta_lease_s: float = META_LEASE_S):
        self.store = store            # ObjectStore or StorageCluster
        # one registry per engine target (a single registry — the seed
        # shape — is the 1-target special case); region ids are globally
        # unique, so grant/renew/revoke address across all of them
        self.registries: List[MemoryRegistry] = \
            list(registry) if isinstance(registry, (list, tuple)) \
            else [registry]
        self.registry = self.registries[0]
        self.tenants = tenants or {"default": "secret"}
        self.meta_lease_s = float(meta_lease_s)
        self._sessions: Dict[int, Session] = {}
        self._ids = itertools.count(1)
        # `_lock` guards the RPC counters only; the session table has its
        # own lock so handlers (dispatched while no lock is held) can touch
        # it without deadlocking against the counter path.
        self._lock = threading.Lock()
        self._sessions_lock = threading.Lock()
        # session_id -> cache-invalidation push channel (MetadataCache hook)
        self._subs: Dict[int, Callable[[str], None]] = {}
        # session_id -> pool-map recall channel (cluster router hook)
        self._map_subs: Dict[int, Callable[[int], None]] = {}
        self.rpc_count = 0
        self.rpc_bytes = 0
        self.compound_ops = 0           # ops carried inside compound RPCs
        self.invalidations_sent = 0     # server->client lease recalls
        # optional FaultInjector (core.faults): "control.rpc.<method>"
        # drop/delay rules and "map.push" lost-recall rules bite here
        self.faults = None
        if hasattr(store, "pool_map"):  # cluster: push every map bump
            store.pool_map.subscribe(self._push_pool_map)

    def add_registry(self, registry: MemoryRegistry) -> None:
        """A new engine target joined: its server registry becomes
        grantable (runtime target add)."""
        self.registries.append(registry)

    def _find_region(self, region_id: int
                     ) -> Optional[Tuple[MemoryRegistry, MemoryRegion]]:
        """The (owning registry, region) for a globally-unique region id —
        a grant must be issued by the registry the target's transport
        resolves against, not just any registry that knows the id."""
        for reg in self.registries:
            mr = reg._regions.get(region_id)
            if mr is not None:
                return reg, mr
        return None

    def _find_rkey(self, token: str) -> Optional[Tuple[MemoryRegistry, Any]]:
        for reg in self.registries:
            rk = reg._rkeys.get(token)
            if rk is not None:
                return reg, rk
        return None

    # -- transport shim ------------------------------------------------------
    def rpc(self, method: str, **payload) -> Dict[str, Any]:
        with self._lock:
            self.rpc_count += 1
            self.rpc_bytes += 64 + sum(
                len(str(v)) for v in payload.values())    # envelope estimate
        if self.faults is not None:
            # injected control-plane anomalies: a "drop" rule loses this
            # request on the wire (the caller sees a failed envelope and
            # retries); a "delay" rule stalls it inside pick()
            f = self.faults.pick(f"control.rpc.{method}")
            if f is not None and f.kind == "drop":
                return {"ok": False, "error": "injected: rpc dropped"}
        fn = getattr(self, f"rpc_{method}", None)
        if fn is None:
            return {"ok": False, "error": f"no method {method}"}
        try:
            out = fn(**payload)
            return {"ok": True, **(out or {})}
        except (AccessError, KeyError, ValueError) as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _session(self, session_id: int) -> Session:
        with self._sessions_lock:
            s = self._sessions.get(session_id)
        if s is None:
            raise AccessError("invalid session")
        return s

    # -- compound (NFSv4-style, ONE round-trip for an ordered op list) -------
    def rpc_compound(self, ops: Sequence[Dict[str, Any]],
                     session_id: Optional[int] = None) -> Dict[str, Any]:
        """Execute `ops` — [{"method": m, "args": {...}}, ...] — in order,
        in this single round-trip. Short-circuit semantics: execution stops
        at the first failing op; `results` holds one entry per ATTEMPTED op
        (the last one carrying the error). A successful `connect` op sets
        the implicit session for the ops after it; ops whose args omit
        `session_id` inherit the compound's current session."""
        results: List[Dict[str, Any]] = []
        sid = session_id
        with self._lock:
            self.compound_ops += len(ops)
        for op in ops:
            method = op.get("method")
            args = dict(op.get("args") or {})
            if method == "compound":              # no recursion
                res = {"ok": False, "error": "nested compound"}
            else:
                fn = getattr(self, f"rpc_{method}", None)
                if fn is None:
                    res = {"ok": False, "error": f"no method {method}"}
                elif (method != "connect" and "session_id" not in args
                        and sid is None):
                    # every op but connect runs under a session; a compound
                    # that never established one fails the op cleanly
                    # instead of TypeError-ing inside the handler
                    res = {"ok": False,
                           "error": f"missing session_id for {method}"}
                else:
                    if sid is not None and method != "connect":
                        args.setdefault("session_id", sid)
                    try:
                        out = fn(**args)
                        res = {"ok": True, **(out or {})}
                    except (AccessError, KeyError, ValueError) as e:
                        res = {"ok": False,
                               "error": f"{type(e).__name__}: {e}"}
            results.append(res)
            if not res["ok"]:
                break
            if method == "connect":
                sid = res["session_id"]
        return {"results": results,
                "completed": sum(r["ok"] for r in results),
                "session_id": sid}

    # -- session / auth --------------------------------------------------
    def rpc_connect(self, tenant: str, secret: str):
        if self.tenants.get(tenant) != secret:
            raise AccessError("authentication failed")
        s = Session(next(self._ids), tenant)
        with self._sessions_lock:
            self._sessions[s.session_id] = s
        return {"session_id": s.session_id,
                "meta_lease_s": self.meta_lease_s}

    def rpc_disconnect(self, session_id: int):
        with self._sessions_lock:
            self._sessions.pop(session_id, None)
            self._subs.pop(session_id, None)
            self._map_subs.pop(session_id, None)
        return {}

    # -- pool map (cluster routing state) ------------------------------------
    def rpc_get_pool_map(self, session_id: int):
        """The versioned pool map: target list with up/down state plus the
        per-container redundancy class — everything a client needs to
        place ops algorithmically with zero per-op metadata lookups.

        Wire form of a redundancy entry (keyed "pool/container"):

            {"replication": r, "write_quorum": q}          # replicated
            {"ec": {"k": k, "p": p, "cell_bytes": cs}}     # erasure-coded

        An `ec` class switches the router onto the striped cell data path
        (k data + p parity cells per block across k+p distinct targets);
        `cell_bytes` is served so clients never derive cell geometry from
        local constants. One refresh after an invalidation (or a
        TargetDownError trip) brings a stale router current; a
        single-engine deployment serves the degenerate one-target map."""
        self._session(session_id)
        if hasattr(self.store, "pool_map"):
            out = self.store.pool_map.describe()
        else:
            out = {"version": 1,
                   "targets": [{"target_id": 0, "up": True}],
                   "redundancy": {}}
        out["lease_ttl_s"] = self.meta_lease_s
        return out

    def subscribe_map(self, session_id: int,
                      callback: Callable[[int], None]) -> None:
        """Register a routed client for pool-map version pushes (the map's
        lease-recall channel). Dropped automatically on disconnect."""
        with self._sessions_lock:
            self._map_subs[session_id] = callback

    def _push_pool_map(self, version: int) -> None:
        """Recall every routed client's cached map: the next op performs
        ONE get_pool_map refresh instead of failing into a dead target.
        A "map.push" drop rule models a LOST recall: the client stays
        stale until a TargetDownError trip forces the refresh (the same
        path `PoolMap.set_state(notify=False)` drives in tests)."""
        with self._sessions_lock:
            subs = list(self._map_subs.values())
        for cb in subs:
            if self.faults is not None:
                f = self.faults.pick("map.push")
                if f is not None and f.kind == "drop":
                    continue          # this client never hears the recall
            with self._lock:
                self.invalidations_sent += 1
            cb(version)

    # -- lease push channel (MetadataCache registration; not an RPC) ---------
    def subscribe(self, session_id: int,
                  callback: Callable[[str], None]) -> None:
        """Register the session's client-side cache for server-driven
        invalidation pushes (the lease-recall channel a real server keeps
        per client). Dropped automatically on disconnect."""
        with self._sessions_lock:
            self._subs[session_id] = callback

    def _notify(self, path: str, origin_session: Optional[int]) -> None:
        """Recall `path` leases from every OTHER session's cache."""
        with self._sessions_lock:
            subs = [(sid, cb) for sid, cb in self._subs.items()
                    if sid != origin_session]
        for _sid, cb in subs:
            with self._lock:
                self.invalidations_sent += 1
            cb(path)

    # -- capability exchange ----------------------------------------------
    def rpc_grant_rkey(self, session_id: int, region_id: int,
                       perms: str = "rw", ttl_s: float = 3600.0):
        s = self._session(session_id)
        found = self._find_region(region_id)
        if found is None:
            raise KeyError(f"no region {region_id}")
        reg, mr = found
        if mr.tenant != s.tenant:
            raise AccessError("cannot grant rkey across protection domains")
        rk = reg.grant(mr, perms, ttl_s)
        return {"rkey": rk.token, "expires_in": ttl_s}

    def rpc_renew_rkey(self, session_id: int, rkey: str,
                       ttl_s: float = 3600.0):
        """Extend a live capability's lease IN PLACE (same token, so NIC
        translation caches holding the key stay valid). Renewal is the
        client's job to do before expiry; the data plane still hard-fails
        an expired or revoked key on every access."""
        s = self._session(session_id)
        found = self._find_rkey(rkey)
        if found is None:
            raise KeyError("unknown rkey")
        reg, rk = found
        if rk.tenant != s.tenant:      # check BEFORE mutating the lease
            raise AccessError("cannot renew rkey across protection domains")
        reg.renew(rkey, ttl_s)
        return {"rkey": rkey, "expires_in": ttl_s}

    def rpc_revoke_rkey(self, session_id: int, rkey: str):
        self._session(session_id)
        found = self._find_rkey(rkey)
        if found is not None:
            found[0].revoke(rkey)
        return {}

    # -- namespace (delegated to DFS metadata) ------------------------------
    def bind_dfs(self, dfs_meta) -> None:
        self._dfs = dfs_meta

    def rpc_mount(self, session_id: int, pool: str, container: str):
        self._session(session_id)
        return {"mount_id": self._dfs.mount(pool, container)}

    def rpc_lookup(self, session_id: int, path: str):
        self._session(session_id)
        out = self._dfs.lookup(path)
        out["lease_ttl_s"] = self.meta_lease_s
        return out

    def rpc_create(self, session_id: int, path: str, is_dir: bool = False):
        self._session(session_id)
        out = self._dfs.create(path, is_dir)
        out["lease_ttl_s"] = self.meta_lease_s
        # recall other sessions' leases only when something actually
        # changed — create-of-existing is a no-op and their leases are fine
        if out.pop("created", False):
            self._notify(out["path"], session_id)
        return out

    def rpc_unlink(self, session_id: int, path: str):
        self._session(session_id)
        out = self._dfs.unlink(path)
        self._notify(self._dfs._norm(path), session_id)
        return out

    def rpc_readdir(self, session_id: int, path: str):
        self._session(session_id)
        return {"entries": self._dfs.readdir(path)}

    def rpc_stat(self, session_id: int, path: str):
        self._session(session_id)
        out = self._dfs.stat(path)
        out["lease_ttl_s"] = self.meta_lease_s
        return out

    def rpc_set_size(self, session_id: int, path: str, size: int):
        self._session(session_id)
        out = self._dfs.set_size(path, size)
        self._notify(self._dfs._norm(path), session_id)
        return out

    def rpc_truncate(self, session_id: int, path: str, size: int):
        self._session(session_id)
        out = self._dfs.truncate(path, size)
        self._notify(self._dfs._norm(path), session_id)
        return out
