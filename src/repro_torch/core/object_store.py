"""DAOS-like object store: pools -> containers -> objects with versioned
extents, end-to-end checksums, replication, failure handling and rebuild.

This is the storage *engine* (server side). It runs entirely in "user
space" — byte storage on Device objects (media.py), no kernel block layer —
mirroring DAOS's SPDK/PMDK design. The DFS POSIX layer (dfs.py) maps files
onto these objects; the client reaches it through the control plane
(namespace/capability RPCs) and data plane (bulk transfers).
"""
from __future__ import annotations

import itertools
import threading
import time
from bisect import insort
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from functools import lru_cache
from typing import (Any, Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core.faults import (DEFAULT_TIMEOUTS, FaultInjector, OpTimeout,
                               Timeouts, note_recovery)
from repro_torch.core.media import Device, checksum, make_nvme_array
from repro_torch.device import DeviceLike, resolve_device


class StorageError(Exception):
    pass


class ChecksumError(StorageError):
    pass


class TargetDownError(StorageError):
    """An op was routed (by a possibly-stale pool map) to an engine target
    the current map marks down. The client reacts with ONE map refresh and
    a re-route, not a failure."""
    pass


@dataclass
class Extent:
    offset: int
    size: int
    epoch: int
    csum: int
    block_keys: Dict[str, int]      # device_name -> block key (replicas)
    # asynchronous replica fan-out bookkeeping (quorum-ack writes); None
    # once every replica landed or for synchronously-committed extents
    pending: Optional["_PendingCommit"] = None


class _PendingCommit:
    """One extent's asynchronous replica fan-out: the op thread returns at
    quorum; straggler replicas land (or demote) in the background.

    The condition variable carries three facts: per-replica completions
    (`ok`/`done`), the op-thread handoff (`acked` — set atomically with the
    collection of pre-ack failures, so op thread and workers never both
    demote the same replica), and cancellation (extent freed/batch aborted
    — a worker that lost the race deletes its own just-written block)."""

    __slots__ = ("quorum", "total", "ok", "done", "failed", "cancelled",
                 "acked", "cv", "timeouts")

    def __init__(self, quorum: int, total: int,
                 timeouts: Timeouts = DEFAULT_TIMEOUTS):
        self.quorum = quorum
        self.total = total
        self.timeouts = timeouts
        self.ok = 0
        self.done = 0
        self.failed: List[Tuple[str, int, Exception]] = []  # (dev, key, err)
        self.cancelled = False
        self.acked = False
        self.cv = threading.Condition()

    def record(self, success: bool, dev_name: str = "", key: int = 0,
               err: Optional[Exception] = None) -> Tuple[bool, bool]:
        """Record one replica completion; returns (acked, cancelled) read
        in the SAME atomic instant, so worker and op thread can never both
        (or neither) own a failure's demotion: a failure lands on the
        `failed` list iff the op thread has not acked yet (it will claim
        the list in ack()); once acked, the returning worker demotes."""
        with self.cv:
            self.done += 1
            if success:
                self.ok += 1
            elif err is not None and not self.acked and not self.cancelled:
                self.failed.append((dev_name, key, err))
            self.cv.notify_all()
            return self.acked, self.cancelled

    def wait_quorum(self, timeout: Optional[float] = None) -> bool:
        """Block until `quorum` replicas landed (True) or every commit
        finished with fewer successes (False)."""
        timeout = self.timeouts.quorum_s if timeout is None else timeout
        start = time.monotonic()
        deadline = start + timeout
        with self.cv:
            while self.ok < self.quorum and self.done < self.total:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self.cv.wait(remaining):
                    raise OpTimeout(
                        "commit.quorum", elapsed_s=time.monotonic() - start,
                        detail=f"{self.ok}/{self.quorum} replicas acked")
            return self.ok >= self.quorum

    def wait_complete(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted replica commit finished (the abort
        path drains stragglers so cleanup is deterministic)."""
        timeout = self.timeouts.drain_s if timeout is None else timeout
        start = time.monotonic()
        deadline = start + timeout
        with self.cv:
            while self.done < self.total:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self.cv.wait(remaining):
                    raise OpTimeout(
                        "commit.drain", elapsed_s=time.monotonic() - start,
                        detail=f"{self.done}/{self.total} commits finished")

    def ack(self) -> List[Tuple[str, int, Exception]]:
        """Op-thread handoff: mark the op returned and claim every failure
        recorded so far (the op thread demotes those; failures recorded
        AFTER this instant are demoted by the worker that hit them)."""
        with self.cv:
            self.acked = True
            claimed, self.failed = self.failed, []
            return claimed

    def cancel(self) -> None:
        with self.cv:
            self.cancelled = True

    @property
    def complete(self) -> bool:
        with self.cv:
            return self.done >= self.total


def _nbytes(data) -> int:
    """Byte length of bytes / memoryview / uint8 ndarray payloads."""
    return data.size if isinstance(data, np.ndarray) else len(data)


@dataclass
class EngineStats:
    """First-class copy/checksum accounting for the engine side of the
    data path (the transport side lives in TransportStats)."""
    checksum_bytes: int = 0          # bytes actually run through the csum
    checksum_skipped_bytes: int = 0  # bytes served from the verified cache
    verify_hits: int = 0
    verify_misses: int = 0
    vcache_invalidations: int = 0
    scrub_bytes: int = 0             # bytes re-verified by the MediaScrubber
    scrub_corruptions: int = 0       # cache entries revoked by the scrubber
    quorum_acks: int = 0             # writes acked before every replica landed
    background_commits: int = 0      # straggler replicas landed post-ack
    replica_demotions: int = 0       # failed replicas dropped + re-replicated
    checksum_offloads: int = 0       # write csums run on commit workers
    hedges_issued: int = 0           # extent reads hedged to a 2nd replica
    hedges_won: int = 0              # hedged reads the 2nd replica won
    cross_target_rereplications: int = 0  # spareless demotions healed on a
    # PEER engine target (cluster-level redundancy restore)
    heal_deferrals: int = 0          # healing waits taken under fg load
    deferred_heal_bytes: int = 0     # healing bytes parked by those waits
    heal_floor_grants: int = 0       # heals forced through at the floor
    ec_rebuilt_cells: int = 0        # lost EC cells regenerated by rebuild
    scrub_parity_checks: int = 0     # EC stripes decode-checked vs parity
    scrub_parity_mismatches: int = 0  # torn/corrupt stripes the parity
    # check caught (parity cells re-marked dirty for rebuild)


class VerifiedExtentCache:
    """Remembers which (device, block-key) replicas have already passed the
    end-to-end Fletcher-64 verify, so warm re-reads skip the checksum pass
    (~0.5 ms/MiB). Entries are keyed by extent identity — block keys are
    globally unique and never reused — and carry the device generation at
    verify time, so a device fail/recover invalidates all of its entries
    implicitly. Explicit invalidation happens on epoch aggregation /
    retire_extents and rebuild; silent in-place corruption (the one thing
    identity keying cannot see) is bounded by the MediaScrubber's budgeted
    background re-verification."""

    def __init__(self, stats: EngineStats, max_entries: int = 1 << 16,
                 enabled: bool = True):
        self.enabled = enabled
        self.max_entries = max_entries
        self.stats = stats
        self._entries: "OrderedDict[Tuple[str, int], Tuple[int, int, int]]" \
            = OrderedDict()          # (dev, key) -> (generation, csum, nbytes)
        self._lock = threading.Lock()

    def check(self, dev_name: str, key: int, generation: int) -> bool:
        if not self.enabled:
            return False
        with self._lock:
            ent = self._entries.get((dev_name, key))
            if ent is None or ent[0] != generation:
                return False
            self._entries.move_to_end((dev_name, key))
            return True

    def insert(self, dev_name: str, key: int, generation: int, csum: int,
               nbytes: int) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._entries[(dev_name, key)] = (generation, csum, nbytes)
            self._entries.move_to_end((dev_name, key))
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def invalidate_block(self, dev_name: str, key: int) -> None:
        with self._lock:
            if self._entries.pop((dev_name, key), None) is not None:
                self.stats.vcache_invalidations += 1

    def invalidate_device(self, dev_name: str) -> None:
        with self._lock:
            stale = [k for k in self._entries if k[0] == dev_name]
            for k in stale:
                del self._entries[k]
            self.stats.vcache_invalidations += len(stale)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def snapshot(self) -> List[Tuple[Tuple[str, int], Tuple[int, int, int]]]:
        with self._lock:
            return list(self._entries.items())


class DAOSObject:
    """Key-array object: (dkey, akey) -> versioned extent list.

    Extent lists are kept epoch-sorted at insert (bisect) so reads never
    re-sort; `fetch_into`/`update_many` are the vectored entry points the
    scatter-gather data path uses (no intermediate `bytes` materialization
    on reads, one epoch + one lock acquisition per write batch)."""

    def __init__(self, oid: int, container: "Container"):
        self.oid = oid
        self.container = container
        self._extents: Dict[Tuple[str, str], List[Extent]] = {}
        self._lock = threading.Lock()
        # serializes xor_apply read-modify-commit cycles (taken OUTSIDE
        # _lock; update_many/fetch acquire _lock internally)
        self._rmw_lock = threading.Lock()

    # -- write ---------------------------------------------------------------
    def update(self, dkey: str, akey: str, offset: int, data: bytes,
               epoch: Optional[int] = None) -> int:
        return self.update_many([(dkey, akey, offset, data)], epoch=epoch)

    def xor_apply(self, dkey: str, akey: str, offset: int, delta,
                  epoch: Optional[int] = None) -> int:
        """Target-side read-modify-XOR — the delta-parity wire op.

        The EC write path ships each parity target ONE delta
        (`C[:, touched] x (old XOR new)` rows from the rs_parity delta
        kernel) instead of a re-encoded cell; this op applies it where
        the parity lives: fetch the current bytes of
        [offset, offset+len(delta)) — holes read as zeros, the zero-pad
        convention parity is computed under, so the first write to a
        stripe XORs onto an implicit zero cell and still lands the exact
        encode — XOR the delta in, and commit the result as one normal
        epoch'd update. No stripe-wide read ever crosses the wire and
        the client pays no second round-trip per parity cell.

        Failure atomicity matches `update_many`: a failed commit aborts
        without tearing the stored bytes, so a client retry re-reads an
        unchanged base and re-applying the same delta is safe. Concurrent
        xor_applies to this object serialize on `_rmw_lock` (two deltas
        must compose by XOR, not overwrite each other's base)."""
        arr = delta if isinstance(delta, np.ndarray) \
            else np.frombuffer(bytes(delta), np.uint8)
        n = int(arr.size)
        if n == 0:
            return self.container.next_epoch() if epoch is None else epoch
        with self._rmw_lock:
            base = np.frombuffer(self.fetch(dkey, akey, offset, n),
                                 np.uint8)
            return self.update_many(
                [(dkey, akey, offset,
                  np.bitwise_xor(base, arr).tobytes())], epoch=epoch)

    def update_many(self, items: Iterable[Tuple[str, str, int, bytes]],
                    epoch: Optional[int] = None,
                    leases: Optional[Sequence] = None) -> int:
        """Apply a batch of (dkey, akey, offset, data) updates under ONE
        epoch with one extent-table lock acquisition. Replica writes and
        checksums happen outside the lock. On containers with
        `aggregate=True`, superseded extent versions (fully covered by a
        newer write) are pruned at insert — DAOS-style epoch aggregation —
        and their device blocks reclaimed after a short epoch grace window
        (so in-flight readers holding a pre-insert snapshot still resolve).

        `data` may be bytes, a memoryview, or a uint8 ndarray. `leases`
        (aligned with `items`) carries staging-ring slot leases: a leased
        payload is DONATED to every replica device — committed by
        reference with zero host copies, each device pinning the lease
        until its deferred writeback (media.py) lands the bytes.

        Replica fan-out is ASYNCHRONOUS: every replica commit of
        every item is submitted to the store's commit pool at once, and
        the op returns when each extent reaches its container's write
        quorum (default: majority of its replicas) — write latency tracks
        the fastest majority, not the slowest replica. Straggler commits
        finish in the background; a replica that fails after the ack is
        DEMOTED (dropped from the extent, verified-cache invalidated) and
        re-replicated onto a spare via the rebuild path's per-extent move.
        Donated leases are pre-pinned once per planned replica on THIS
        thread, so a slot can never return to the ring while a background
        commit still sources from it."""
        cont = self.container
        store = cont.store
        epoch = cont.next_epoch() if epoch is None else epoch
        items = list(items)
        leases = list(leases) if leases is not None else [None] * len(items)
        staged: List[tuple] = []
        for (dkey, akey, offset, data), lease in zip(items, leases):
            payload = data if isinstance(data, (bytes, np.ndarray)) \
                else bytes(data)
            live = [t for t in cont.placement(self.oid, dkey) if t.alive]
            if len(live) < 1:                     # validate the whole batch
                raise StorageError("no live targets for update")
            staged.append((dkey, akey, offset, payload,
                           live[:cont.replication], lease))
        prepped: List[Tuple[Tuple[str, str], Extent]] = []
        planned: List[Tuple[Device, int]] = []    # every (dev, key) submitted
        csum_futs: List = []          # aligned with prepped; None = inline
        try:
            for dkey, akey, offset, payload, targets, lease in staged:
                n = _nbytes(payload)
                rec = _PendingCommit(cont.commit_quorum(len(targets)),
                                     len(targets), timeouts=store.timeouts)
                # quorum == width means the op must wait for every replica
                # anyway: commit inline, no pool hop (the replication=2
                # default keeps its inline-commit latency). A sub-width quorum fans
                # out so the op can return while stragglers are in flight.
                fan_out = rec.quorum < len(targets)
                if fan_out:
                    # quorum path (replication >= 3): the Fletcher-64 runs
                    # on a commit worker, OVERLAPPED with the replica media
                    # writes, so the op thread no longer pays a synchronous
                    # per-byte checksum before fan-out. The extent stays
                    # invisible until both the quorum AND the checksum
                    # resolved (readers never see a placeholder csum).
                    csum_fut = store.commit_pool.submit(
                        store._checksum_offload, payload)
                    csum = 0
                else:                 # inline commit keeps the sync csum
                    csum_fut = None
                    csum = store.csum(payload)
                    with store._stats_lock:
                        store.stats.checksum_bytes += n
                keys: Dict[str, int] = {}
                ext = Extent(offset, n, epoch, csum, keys, pending=rec)
                prepped.append(((dkey, akey), ext))
                csum_futs.append(csum_fut)
                pinned = submitted = 0
                try:
                    if lease is not None:
                        for _ in targets:         # pre-pin: one per replica
                            lease.pin()
                            pinned += 1
                    for dev in targets:
                        key = store.new_block_key()
                        keys[dev.name] = key
                        planned.append((dev, key))
                        if fan_out:
                            store.commit_pool.submit(
                                self._commit_replica, dev, key, payload,
                                lease, rec, ext)
                        else:
                            self._commit_replica(dev, key, payload, lease,
                                                 rec, ext)
                        submitted += 1
                except Exception:
                    # replicas never handed to a worker (pool shut down
                    # mid-batch, etc.): release their pre-pins ourselves
                    # and shrink the record so the abort drain converges
                    if lease is not None:
                        for _ in range(pinned - submitted):
                            lease.unpin()
                    with rec.cv:
                        rec.total -= len(targets) - submitted
                    raise
        except Exception:
            self._abort_commit_batch(prepped, planned)
            raise
        # wait for every item's quorum before ANY extent becomes visible
        # (batch atomicity: a batch either inserts all its extents or none)
        failed_item = None
        for _k, ext in prepped:
            try:
                if not ext.pending.wait_quorum():
                    failed_item = ext
                    break
            except (StorageError, TimeoutError):
                failed_item = ext
                break
        if failed_item is not None:
            self._abort_commit_batch(prepped, planned)
            errs = failed_item.pending.failed
            raise StorageError(
                f"replica commit quorum failed: "
                f"{errs[-1][2] if errs else 'commit timeout'}")
        # land the offloaded checksums BEFORE any extent becomes visible
        # (or any demotion consults ext.csum for re-replication salting)
        for (_k, ext), fut in zip(prepped, csum_futs):
            if fut is not None:
                ext.csum = fut.result()
        for _k, ext in prepped:
            # op-thread handoff: demote replicas that failed pre-ack (the
            # quorum still succeeded), count a quorum ack if stragglers
            # are still in flight
            pre_ack_failures = ext.pending.ack()
            if not ext.pending.complete:
                with store._stats_lock:
                    store.stats.quorum_acks += 1
            if ext.pending.complete and not pre_ack_failures:
                ext.pending = None                # fully landed: no tracking
            for dev_name, key, _err in pre_ack_failures:
                self._demote_replica(ext, dev_name, key)
        retired: List[Extent] = []
        with self._lock:
            for k, ext in prepped:
                lst = self._extents.setdefault(k, [])
                if cont.aggregate:
                    lo, hi = ext.offset, ext.offset + ext.size
                    keep = []
                    for e in lst:
                        if (e.epoch < ext.epoch and lo <= e.offset
                                and e.offset + e.size <= hi):
                            retired.append(e)
                        else:
                            keep.append(e)
                    lst[:] = keep
                insort(lst, ext, key=lambda e: e.epoch)
        if retired:
            cont.retire_extents(epoch, retired)
        return epoch

    def _abort_commit_batch(self, prepped, planned) -> None:
        """Abort an update_many batch: cancel the fan-outs, DRAIN the
        workers (so every pre-pin is deterministically released), then
        free whatever landed — without this the blocks would leak in
        Device._blocks and donated leases would pin staging slots."""
        for _k, ext in prepped:
            ext.pending.cancel()
        for _k, ext in prepped:
            ext.pending.wait_complete()
        for dev, key in planned:
            dev.delete(key)

    def _commit_replica(self, dev: Device, key: int, payload, lease,
                        rec: _PendingCommit, ext: Extent) -> None:
        """One replica's media commit, run on the store's commit pool.
        Post-write it re-checks cancellation (the batch may have aborted,
        or the extent may have been punched, while we were writing) and
        deletes its own block if it lost that race — a cancelled extent
        must never resurrect. A failure AFTER the op-thread ack demotes
        the replica from here (pre-ack failures are the op thread's)."""
        store = self.container.store
        with rec.cv:
            cancelled = rec.cancelled
        if cancelled:
            if lease is not None:
                lease.unpin()                     # release our pre-pin
            rec.record(False)
            return
        try:
            dev.write(key, payload, lease=lease,
                      pre_pinned=lease is not None)
        except (StorageError, OSError) as e:      # degraded replica
            if lease is not None:
                lease.unpin()                     # write never consumed it
            acked, cancelled = rec.record(False, dev.name, key, e)
            if acked and not cancelled:
                # post-ack failure on a LIVE extent: ours to demote (a
                # pre-ack failure was claimed by the op thread in ack();
                # a cancelled extent is already being freed — demoting or
                # re-replicating it would resurrect reclaimed data)
                self._demote_replica(ext, dev.name, key)
            return
        acked, cancelled = rec.record(True)
        if cancelled:
            dev.delete(key)                       # late write: take it back
            return
        if acked:
            with store._stats_lock:
                store.stats.background_commits += 1

    def _demote_replica(self, ext: Extent, dev_name: str, key: int) -> None:
        """A replica commit failed while the op already (or concurrently)
        succeeded at quorum: drop the dead replica from the extent — a
        reader must never wait on a block that will never land — and feed
        the rebuild path's per-extent move to restore replication width.
        A cancelled extent (punched/retired while the straggler was in
        flight) is never demoted or re-replicated: that would resurrect
        reclaimed data; if the cancel lands DURING our re-replication, the
        fresh block is taken back (the free loop snapshotted the key list
        before we added it, so nobody else will)."""
        cont = self.container
        rec = ext.pending
        if rec is not None:
            with rec.cv:
                if rec.cancelled:
                    return
        if ext.block_keys.get(dev_name) != key:
            return                                # already demoted/rebuilt
        ext.block_keys.pop(dev_name, None)
        cont.vcache.invalidate_block(dev_name, key)
        with cont.store._stats_lock:
            cont.store.stats.replica_demotions += 1
        try:
            # never re-replicate onto the device that just failed the
            # commit — it is suspect even while it still reports alive
            new_name = self._rereplicate(ext, exclude=(dev_name,))
            note_recovery(cont.store.faults, "media.rereplicated")
        except StorageError:
            # no LOCAL spare: escalate to the cluster (if one hosts this
            # engine) so redundancy is restored on a PEER target's devices
            # instead of silently staying degraded until rebuild
            cb = cont.store.on_spareless_demotion
            if cb is not None:
                try:
                    cb(self, ext)
                # lint: allow(broad-except): cluster heal is best-effort
                # from a straggler commit worker — ANY escalation failure
                # (peer down mid-heal, map churn) must not break the
                # demotion path; the extent stays degraded and rebuild
                # retries it
                except Exception:
                    pass
            return
        if rec is not None:
            with rec.cv:
                cancelled = rec.cancelled
            if cancelled:
                new_key = ext.block_keys.pop(new_name, None)
                if new_key is not None:
                    cont.vcache.invalidate_block(new_name, new_key)
                    dev = cont.store.device(new_name)
                    if dev is not None:
                        dev.delete(new_key)

    def _rereplicate(self, ext: Extent, salt: int = 0,
                     exclude: Sequence[str] = ()) -> str:
        """Copy one extent onto a spare device from a verified surviving
        replica (shared by rebuild and post-ack demotion). Candidates that
        fail the write are skipped for the next spare. Returns the chosen
        device name; raises StorageError when no spare accepts."""
        cont = self.container
        data = self._read_extent(ext, verify=True, cache=False)
        candidates = [d for d in cont.store.devices
                      if d.alive and d.name not in ext.block_keys
                      and d.name not in exclude]
        if not candidates:
            raise StorageError("no spare target for rebuild")
        start = (ext.csum + salt) % len(candidates)
        last_err: Optional[Exception] = None
        for i in range(len(candidates)):
            dev = candidates[(start + i) % len(candidates)]
            key = cont.store.new_block_key()
            try:
                dev.write(key, data)
            except (StorageError, OSError) as e:
                last_err = e
                continue
            ext.block_keys[dev.name] = key
            return dev.name
        raise StorageError(f"no spare accepted the rebuild write: {last_err}")

    # -- read ----------------------------------------------------------------
    def fetch(self, dkey: str, akey: str, offset: int, size: int,
              epoch: Optional[int] = None, verify: bool = True) -> bytes:
        out = np.empty(size, np.uint8)
        self.fetch_into(dkey, akey, offset, size, out,
                        epoch=epoch, verify=verify)
        return out.tobytes()

    def fetch_into(self, dkey: str, akey: str, offset: int, size: int,
                   out, out_off: int = 0, epoch: Optional[int] = None,
                   verify: bool = True) -> int:
        """Fill a caller-provided buffer (np.uint8 array / bytearray /
        writable memoryview) with the extent overlay — no intermediate
        `bytes(size)` materialization. Returns `size`."""
        dst = (out if isinstance(out, np.ndarray)
               else np.frombuffer(out, np.uint8))
        view = dst[out_off:out_off + size]
        return self.fetch_scatter(dkey, akey, offset, size,
                                  [(view, 0, size)],
                                  epoch=epoch, verify=verify)

    def fetch_scatter(self, dkey: str, akey: str, offset: int, size: int,
                      dsts: Sequence[Tuple[np.ndarray, int, int]],
                      epoch: Optional[int] = None,
                      verify: bool = True) -> int:
        """Scatter the extent overlay for [offset, offset+size) STRAIGHT
        into caller-provided destination spans — the direct-splice read
        path: no staging bounce exists between the verified replica bytes
        and the caller's (registered) memory. `dsts` is [(view, lo, hi)]
        where [lo, hi) are range-relative byte coordinates covering
        [0, size) and `view` is a writable uint8 view of length hi-lo
        (e.g. the views a transport `place_sg` handed back). Checksum
        verification runs per replica read, with the verified-extent cache
        intact, exactly as on the staged path. Returns `size`.

        If a concurrent writer aggregates away an extent from our snapshot
        (its device blocks reclaimed after the grace window), the read
        restarts on a fresh snapshot — the superseding extent is newer than
        ours, so the retry observes a consistent, more recent state."""
        for attempt in range(8):
            with self._lock:
                exts = list(self._extents.get((dkey, akey), ()))
            # holes read as zeros — but pre-zeroing is pure overhead when
            # any (epoch-visible) extent fully covers the range, since it
            # writes every destination byte anyway (the hot aligned-block
            # read: one extent, whole block). Only memset when a hole is
            # actually possible.
            if not any(e.offset <= offset
                       and e.offset + e.size >= offset + size
                       for e in exts
                       if epoch is None or e.epoch <= epoch):
                for view, lo, hi in dsts:
                    view[:hi - lo] = 0
            try:
                # epoch-sorted at insert: newer writes overlay older
                for ext in exts:
                    if epoch is not None and ext.epoch > epoch:
                        continue
                    elo = max(offset, ext.offset) - offset
                    ehi = min(offset + size, ext.offset + ext.size) - offset
                    if elo >= ehi:
                        continue
                    src: Optional[memoryview] = None
                    for view, lo, hi in dsts:
                        s0, s1 = max(elo, lo), min(ehi, hi)
                        if s0 >= s1:
                            continue
                        if src is None:         # one replica read per extent
                            src = memoryview(self._read_extent(ext, verify))
                        span = src[s0 + offset - ext.offset:
                                   s1 + offset - ext.offset]
                        view[s0 - lo:s1 - lo] = np.frombuffer(span, np.uint8)
                return size
            except StorageError:
                with self._lock:
                    still_there = ext in self._extents.get((dkey, akey), ())
                if still_there or attempt == 7:
                    raise               # genuine replica failure
        return size

    def _hedged_read(self, replicas: List[Tuple[str, int, Device]],
                     timeout: float) -> Tuple[str, int, bytes]:
        """Race the primary replica read against the SECOND replica when
        the primary exceeds the hedge budget — extent-granularity straggler
        mitigation (the 3FS/loader trick moved from whole-op duplication in
        the data pipeline down to the one extent that is actually slow).
        First successful completion wins; the loser finishes harmlessly in
        the background. Returns (dev_name, key, data) of the winner; raises
        the primary's error if every raced replica failed."""
        from concurrent.futures import FIRST_COMPLETED, wait as _fwait
        store = self.container.store
        (n0, k0, d0), (n1, k1, d1) = replicas[0], replicas[1]
        primary = store.hedge_pool.submit(d0.read, k0)
        done, _ = _fwait([primary], timeout=timeout,
                         return_when=FIRST_COMPLETED)
        if done:
            return n0, k0, primary.result()      # may raise: caller reroutes
        with store._stats_lock:
            store.stats.hedges_issued += 1
        backup = store.hedge_pool.submit(d1.read, k1)
        pending = {primary: (n0, k0), backup: (n1, k1)}
        last_err: Optional[Exception] = None
        while pending:
            done, _ = _fwait(list(pending), return_when=FIRST_COMPLETED)
            for fut in done:
                name, key = pending.pop(fut)
                try:
                    data = fut.result()
                except (StorageError, OSError, KeyError) as e:
                    last_err = e
                    continue
                if fut is backup:
                    with store._stats_lock:
                        store.stats.hedges_won += 1
                return name, key, data
        raise last_err if last_err is not None \
            else StorageError("hedged read lost both replicas")

    def _read_extent(self, ext: Extent, verify: bool,
                     cache: bool = True) -> bytes:
        """Read one replica of the extent, verifying the end-to-end
        checksum unless the verified-extent cache already vouches for this
        (device, block, generation) — the warm-read fast path that skips
        the Fletcher-64 pass entirely. `cache=False` forces a full verify
        AND skips cache insertion (rebuild uses it: data about to be
        re-replicated must never be trusted on faith).

        With `store.hedge_timeout_s` set and >= 2 live replicas, the
        primary read is HEDGED: if it exceeds the budget the second
        replica's target is raced and the first completion wins — counted
        at extent granularity in `hedges_issued`/`hedges_won`."""
        cont = self.container
        store = cont.store
        last_err: Optional[Exception] = None
        # snapshot: a post-ack demotion/re-replication may mutate the
        # replica map concurrently from a commit-pool worker
        live = [(name, key, store.device(name))
                for name, key in list(ext.block_keys.items())]
        live = [(n, k, d) for n, k, d in live if d is not None and d.alive]
        hedge = store.hedge_timeout_s
        if hedge is not None and len(live) >= 2:
            try:
                name, key, data = self._hedged_read(live, hedge)
            except (StorageError, OSError, KeyError) as e:
                last_err = e
            else:
                err = self._verify_replica(ext, name, key, verify, cache,
                                           data)
                if err is None:
                    return data
                last_err = err
                live = [(n, k, d) for n, k, d in live if n != name]
        for name, key, dev in live:
            try:
                data = dev.read(key)
            except (StorageError, OSError, KeyError) as e:  # degraded
                last_err = e
                continue
            err = self._verify_replica(ext, name, key, verify, cache, data)
            if err is not None:
                last_err = err
                continue               # silent-corruption -> next replica
            if last_err is not None:
                # an earlier replica failed and THIS one served the read:
                # the degraded-read failover path ran to completion
                note_recovery(store.faults, "read.degraded_replica")
            return data
        raise StorageError(f"extent unreadable from all replicas: {last_err}")

    def _verify_replica(self, ext: Extent, name: str, key: int,
                        verify: bool, cache: bool,
                        data) -> Optional[Exception]:
        """End-to-end verify of one replica's bytes (verified-cache fast
        path included); returns None on pass, the ChecksumError on a
        mismatch. Shared by the sequential and hedged read paths."""
        if not verify:
            return None
        cont = self.container
        store = cont.store
        dev = store.device(name)
        generation = dev.generation if dev is not None else -1
        n = _nbytes(data)
        if cache and cont.vcache.check(name, key, generation):
            with store._stats_lock:
                store.stats.verify_hits += 1
                store.stats.checksum_skipped_bytes += n
        elif store.csum(data) != ext.csum:
            with store._stats_lock:
                store.stats.verify_misses += 1
                store.stats.checksum_bytes += n
            return ChecksumError(f"extent csum mismatch on {name}")
        else:
            with store._stats_lock:
                store.stats.verify_misses += 1
                store.stats.checksum_bytes += n
            if cache:
                cont.vcache.insert(name, key, generation, ext.csum, n)
        return None

    # -- punch (truncate / unlink reclaim) -----------------------------------
    def _free_extent(self, ext: Extent) -> int:
        """Release an extent's replica blocks back to media (verified-cache
        entries dropped first: a stale entry must never vouch for a freed
        block key if it were ever reused). An in-flight background commit
        is cancelled first, so a straggler replica landing after the free
        deletes its own block instead of resurrecting the extent.
        Returns logical bytes freed."""
        if ext.pending is not None:
            ext.pending.cancel()
        for name, key in list(ext.block_keys.items()):
            self.container.vcache.invalidate_block(name, key)
            dev = self.container.store.device(name)
            if dev is not None:
                dev.delete(key)
        return ext.size

    def punch(self, dkey: str, akey: str) -> int:
        """Drop EVERY extent version under (dkey, akey) and free the device
        blocks immediately — truncate/unlink reclaim, not aggregation, so
        no grace window: a concurrent snapshot reader racing the punch
        retries onto the post-punch state (holes read as zeros), which is
        the documented semantics of racing a truncate."""
        with self._lock:
            exts = self._extents.pop((dkey, akey), [])
        return sum(self._free_extent(e) for e in exts)

    def punch_range(self, dkey: str, akey: str, keep_upto: int) -> int:
        """Trim (dkey, akey) to [0, keep_upto): extents fully beyond are
        freed; an extent straddling the boundary is rewritten to its kept
        prefix (fresh replica blocks + checksum) so a later re-grow reads
        zeros, not resurrected bytes. Returns logical bytes freed."""
        with self._lock:
            lst = self._extents.get((dkey, akey))
            snapshot = list(lst) if lst else []
        dead = [e for e in snapshot if e.offset >= keep_upto]
        straddle = [e for e in snapshot
                    if e.offset < keep_upto < e.offset + e.size]
        if not dead and not straddle:
            return 0
        cont = self.container
        replacements: List[Extent] = []
        for ext in straddle:
            keep = keep_upto - ext.offset
            data = memoryview(self._read_extent(ext, verify=True,
                                                cache=False))[:keep]
            payload = bytes(data)
            keys: Dict[str, int] = {}
            for name in list(ext.block_keys):
                dev = cont.store.device(name)
                if dev is None or not dev.alive:
                    continue
                key = cont.store.new_block_key()
                dev.write(key, payload)
                keys[name] = key
            replacements.append(Extent(ext.offset, keep, ext.epoch,
                                       cont.store.csum(payload), keys))
        gone = set(map(id, dead)) | set(map(id, straddle))
        with self._lock:
            lst = self._extents.get((dkey, akey), [])
            kept = [e for e in lst if id(e) not in gone]
            for r in replacements:
                insort(kept, r, key=lambda e: e.epoch)
            if kept:
                self._extents[(dkey, akey)] = kept
            else:
                self._extents.pop((dkey, akey), None)
        freed = sum(self._free_extent(e) for e in dead)
        for ext in straddle:
            freed += self._free_extent(ext) - (keep_upto - ext.offset)
        return freed

    def dkeys(self, akey: str) -> List[str]:
        """Distribution keys that currently hold extents under `akey`
        (truncate punches by what EXISTS, not by what metadata says)."""
        with self._lock:
            return [dk for (dk, ak) in self._extents if ak == akey]

    def _locate_extent(self, ext: Extent) -> Optional[Tuple[str, str]]:
        """Reverse-map a live extent to its (dkey, akey) — the cluster's
        spareless-demotion escalation needs the key to re-home the extent
        on a peer target. Identity search; None if the extent was punched
        or retired meanwhile (nothing to heal then)."""
        with self._lock:
            for k, lst in self._extents.items():
                if any(e is ext for e in lst):
                    return k
        return None

    def punch_all(self) -> int:
        """Free every extent of the object (unlink reclaim)."""
        with self._lock:
            all_lists = list(self._extents.values())
            self._extents.clear()
        return sum(self._free_extent(e) for lst in all_lists for e in lst)

    def rebuild(self, failed: str) -> int:
        """Re-replicate extents that lived on a failed device."""
        cont = self.container
        moved = 0
        with self._lock:
            all_exts = [e for lst in self._extents.values() for e in lst]
        for ext in all_exts:
            if failed not in ext.block_keys:
                continue
            old_key = ext.block_keys.pop(failed, None)
            if old_key is not None:
                cont.vcache.invalidate_block(failed, old_key)
            # bypass the verified cache: rebuild re-verifies the replica it
            # copies from, and the failed device's entries are dropped
            self._rereplicate(ext, salt=moved)
            moved += 1
        return moved


class Container:
    """`aggregate=True` enables DAOS-style epoch aggregation: a write that
    fully covers older extents retires them (device blocks reclaimed after
    an epoch grace window). Off by default — epoch-snapshot reads below the
    aggregation horizon then keep full history (the seed semantics).

    `verified_cache=True` enables the warm-read checksum skip. Off by
    default for the bare engine primitive (every read verifies, the seed
    semantics): the cache is only honest when something runs a
    MediaScrubber against the store, which ROS2Client wires up when it
    opts in.

    `write_quorum` is the replica-ack threshold for quorum writes: None
    (default) means majority of an extent's replicas — with replication 2
    that is both replicas, preserving the seed's wait-for-all semantics;
    with replication 3 a write returns at 2 and the straggler lands in the
    background. Pass an explicit int (capped at the replica count) to
    widen or narrow it; `write_quorum=replication` restores full fan-out
    latency for comparison."""

    AGGREGATE_GRACE_EPOCHS = 4

    def __init__(self, name: str, pool: "Pool", replication: int = 2,
                 aggregate: bool = False, verified_cache: bool = False,
                 write_quorum: Optional[int] = None):
        self.name = name
        self.pool = pool
        self.store = pool.store
        self.replication = max(1, min(replication, len(self.store.devices)))
        self.write_quorum = write_quorum
        self.aggregate = aggregate
        self.vcache = VerifiedExtentCache(self.store.stats,
                                         enabled=verified_cache)
        self._objects: Dict[int, DAOSObject] = {}
        self._destroyed: set = set()      # oids gone for good (never reused)
        self._epoch = itertools.count(1)
        self._epoch_now = 0
        self._lock = threading.Lock()
        self._retired: List[Tuple[int, Extent]] = []

    def next_epoch(self) -> int:
        with self._lock:
            self._epoch_now = next(self._epoch)
            return self._epoch_now

    def commit_quorum(self, n_targets: int) -> int:
        """Replica-ack threshold for an extent with `n_targets` replicas:
        the configured write_quorum (capped) or a majority."""
        q = self.write_quorum if self.write_quorum is not None \
            else n_targets // 2 + 1
        return max(1, min(n_targets, q))

    def retire_extents(self, epoch: int, extents: List[Extent]) -> None:
        """Queue superseded extents; free their device blocks once the
        grace window has passed (in-flight snapshot readers drain first).
        A retiring extent's verified-cache entries are dropped IMMEDIATELY
        (not at reclaim): a stale cache must never vouch for a retired
        extent, even during the grace window."""
        grace = self.AGGREGATE_GRACE_EPOCHS
        for ext in extents:
            for name, key in list(ext.block_keys.items()):
                self.vcache.invalidate_block(name, key)
        with self._lock:
            self._retired.extend((epoch, e) for e in extents)
            ready = [e for ep, e in self._retired if ep <= epoch - grace]
            self._retired = [(ep, e) for ep, e in self._retired
                             if ep > epoch - grace]
        for ext in ready:
            if ext.pending is not None:     # straggler commits must not
                ext.pending.cancel()        # resurrect a reclaimed extent
            for name, key in list(ext.block_keys.items()):
                dev = self.store.device(name)
                if dev is not None:
                    dev.delete(key)

    @property
    def epoch(self) -> int:
        return self._epoch_now

    def peek_object(self, oid: int) -> Optional[DAOSObject]:
        """The object if it exists HERE, else None — no lazy creation, no
        tombstone raise (fleet-wide facades enumerate with this so a fan-
        out punch on one target never materializes empty objects on the
        others)."""
        with self._lock:
            return self._objects.get(oid)

    def object(self, oid: int) -> DAOSObject:
        with self._lock:
            if oid in self._destroyed:
                # lazily re-creating a destroyed object would resurrect an
                # unreferenced orphan whose extents leak forever (writes on
                # an fd that outlived its unlink land here — ESTALE)
                raise StorageError(f"object {oid} destroyed")
            if oid not in self._objects:
                self._objects[oid] = DAOSObject(oid, self)
            return self._objects[oid]

    def destroy_object(self, oid: int) -> int:
        """Unlink reclaim: drop the object and free all its device blocks
        (capacity returns to the array immediately — the bug this fixes is
        extents living forever after the namespace entry is gone). The oid
        is tombstoned so late writers cannot resurrect an orphan. Returns
        logical bytes freed; 0 for an object that was never written."""
        with self._lock:
            obj = self._objects.pop(oid, None)
            self._destroyed.add(oid)
        return obj.punch_all() if obj is not None else 0

    def placement(self, oid: int, dkey: str) -> List[Device]:
        """Consistent-hash-style placement over targets."""
        devs = self.store.devices
        start = hash((oid, dkey)) % len(devs)
        return [devs[(start + i) % len(devs)] for i in range(len(devs))]

    def rebuild(self, failed: str) -> int:
        with self._lock:
            objs = list(self._objects.values())
        return sum(o.rebuild(failed) for o in objs)


class Pool:
    def __init__(self, name: str, store: "ObjectStore"):
        self.name = name
        self.store = store
        self.containers: Dict[str, Container] = {}

    def create_container(self, name: str, replication: int = 2,
                         aggregate: bool = False,
                         verified_cache: bool = False,
                         write_quorum: Optional[int] = None) -> Container:
        c = Container(name, self, replication, aggregate=aggregate,
                      verified_cache=verified_cache,
                      write_quorum=write_quorum)
        self.containers[name] = c
        return c


class ObjectStore:
    """The DAOS I/O engine's storage core (one per storage server).

    `csum` selects the end-to-end extent checksum: the default is the
    vectorized Fletcher-64 (media.checksum, matching the port's fletcher
    kernel, `kernels/fletcher`); pass media.crc32_checksum to reproduce the seed's scalar CRC
    path (the `legacy=True` benchmark baseline)."""

    def __init__(self, devices: List[Device],
                 csum: Optional[Callable[[bytes], int]] = None,
                 timeouts: Timeouts = DEFAULT_TIMEOUTS):
        assert devices, "need at least one device"
        self.devices = devices
        self.pools: Dict[str, Pool] = {}
        self._block_keys = itertools.count(1)
        self.csum = csum or checksum
        self.timeouts = timeouts
        # optional fault injector (faults.py); wired by the owner, shared
        # with the devices/cluster so one schedule spans every layer
        self.faults: Optional[FaultInjector] = None
        self.stats = EngineStats()
        self._stats_lock = threading.Lock()
        self._commit_pool: Optional[ThreadPoolExecutor] = None
        self._hedge_pool: Optional[ThreadPoolExecutor] = None
        self._commit_pool_lock = threading.Lock()
        # extent-level hedged reads: when set, _read_extent races the
        # second replica once the primary exceeds this budget (seconds)
        self.hedge_timeout_s: Optional[float] = None
        # cluster escalation: called (obj, ext) when a post-ack demotion
        # finds no local spare — StorageCluster re-homes the extent on a
        # peer engine target; None for a standalone engine
        self.on_spareless_demotion: Optional[
            Callable[[DAOSObject, Extent], None]] = None

    def _checksum_offload(self, payload) -> int:
        """Write-path Fletcher-64, run on a commit worker so the quorum
        fan-out overlaps the per-byte checksum with the replica media
        writes instead of paying it synchronously on the op thread."""
        c = self.csum(payload)
        with self._stats_lock:
            self.stats.checksum_bytes += _nbytes(payload)
            self.stats.checksum_offloads += 1
        return c

    @property
    def commit_pool(self) -> ThreadPoolExecutor:
        """Shared replica-commit pool (quorum-ack write fan-out): sized so
        every replica of a staging-ring-wide batch can be in flight on
        media at once."""
        with self._commit_pool_lock:
            if self._commit_pool is None:
                self._commit_pool = ThreadPoolExecutor(
                    max_workers=max(4, 2 * len(self.devices)),
                    thread_name_prefix="replica-commit")
            return self._commit_pool

    @property
    def hedge_pool(self) -> ThreadPoolExecutor:
        """Dedicated executor for hedged replica reads. NOT the commit
        pool: hedge waiters can run ON commit workers (post-ack demotion's
        re-replication reads, cross-target heals), and a bounded pool
        whose workers block on futures queued behind themselves deadlocks.
        Hedge tasks are plain device reads that never submit further work,
        so this pool is cycle-free at any size."""
        with self._commit_pool_lock:
            if self._hedge_pool is None:
                self._hedge_pool = ThreadPoolExecutor(
                    max_workers=max(4, 2 * len(self.devices)),
                    thread_name_prefix="hedge-read")
            return self._hedge_pool

    def close(self) -> None:
        with self._commit_pool_lock:
            pool, self._commit_pool = self._commit_pool, None
            hedge, self._hedge_pool = self._hedge_pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        if hedge is not None:
            hedge.shutdown(wait=True)

    def containers(self) -> List[Container]:
        return [c for p in self.pools.values()
                for c in p.containers.values()]

    def create_pool(self, name: str) -> Pool:
        p = Pool(name, self)
        self.pools[name] = p
        return p

    def device(self, name: str) -> Optional[Device]:
        for d in self.devices:
            if d.name == name:
                return d
        return None

    def new_block_key(self) -> int:
        return next(self._block_keys)

    def fail_device(self, name: str) -> None:
        d = self.device(name)
        if d:
            d.fail()

    def rebuild(self, failed: str) -> int:
        moved = 0
        for p in self.pools.values():
            for c in p.containers.values():
                moved += c.rebuild(failed)
        return moved


# ---------------------------------------------------------------------------
# Multi-target cluster layer: versioned pool map + N independent engines.


def _place_key(oid: int, dkey: str) -> int:
    """Deterministic 64-bit placement key (FNV-1a over "oid:dkey") — NOT
    Python's salted hash(), so placement is stable across processes and
    runs (clients and servers must agree on it forever)."""
    h = 0xCBF29CE484222325
    for ch in f"{oid}:{dkey}".encode():
        h = ((h ^ ch) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def jump_hash(key: int, n_buckets: int) -> int:
    """Jump consistent hash (Lamping & Veach): maps `key` onto one of
    `n_buckets` with the minimal-disruption property — growing the fleet
    from n to n+1 targets moves only ~1/(n+1) of the keys, which is what
    makes target ADD cheap (no full reshuffle, no per-object metadata)."""
    if n_buckets <= 1:
        return 0
    key &= 0xFFFFFFFFFFFFFFFF
    b, j = -1, 0
    while j < n_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & 0xFFFFFFFFFFFFFFFF
        j = int((b + 1) * ((1 << 31) / ((key >> 33) + 1)))
    return b


@lru_cache(maxsize=1 << 16)
def placement_order(n_targets: int, oid: int, dkey: str,
                    domains: Optional[Tuple[Optional[str], ...]] = None
                    ) -> Tuple[int, ...]:
    """Deterministic target preference order for (oid, dkey): the jump-
    hash primary first, then the ring successors (the failover / cross-
    target-redundancy candidates, in the order every client and server
    derives identically with ZERO per-op metadata lookups). Computed over
    ALL registered targets — up/down filtering happens at selection time,
    so a target bouncing does not reshuffle placement.

    `domains` (optional, position-aligned fault-domain labels from the
    pool map) spreads the SUCCESSOR picks across distinct fault domains:
    the primary is unchanged (flat data placement is untouched), but each
    following pick prefers the least-represented domain so replicas and
    failover candidates land across racks/hosts, ring order breaking
    ties. With no labels (None / all-None) the flat ring is returned
    bit-identically to the unlabeled fleet."""
    primary = jump_hash(_place_key(oid, dkey), n_targets)
    ring = tuple((primary + i) % n_targets for i in range(n_targets))
    if (domains is None or len(domains) != n_targets
            or all(d is None for d in domains)):
        return ring
    order = [ring[0]]
    seen: Dict[Optional[str], int] = {domains[ring[0]]: 1}
    rest = list(ring[1:])
    while rest:
        nxt = min(rest, key=lambda t: (seen.get(domains[t], 0),
                                       rest.index(t)))
        rest.remove(nxt)
        order.append(nxt)
        seen[domains[nxt]] = seen.get(domains[nxt], 0) + 1
    return tuple(order)


# ---------------------------------------------------------------------------
# erasure-coded redundancy class geometry
#
# ec(k,p) stripes each data-path block over k+p DISTINCT targets in
# placement order: cell i of block dkey lives on target order[i] under the
# SAME (dkey, akey) the replicated layout uses, at block-relative extent
# offsets [i*cs, (i+1)*cs) with cs = EC_STRIPE_BYTES // k.  Data cells
# (i < k) therefore sit at their natural file offsets — healthy reads and
# writes ride the unchanged per-target session machinery with only the
# routing swapped — while parity cells (i >= k) sit at VIRTUAL offsets at
# or beyond the block size, unreachable through the file-offset API by
# construction.  Cell identity is self-describing: extent.offset // cs.
#
# EC_STRIPE_BYTES must equal dfs.BLOCK (the data-path block size); dfs
# imports object_store, so the constant lives here and dfs asserts against
# it at import.
EC_STRIPE_BYTES = 1 << 20

# Per-stripe dirty-cell ledger: when a cell write is dropped (its target
# down / crashed mid-op), the writer records a one-byte marker at offset
# `cell_index` under (dkey, EC_DIRTY_AKEY) on every UP stripe target —
# 0x01 = stale (content predates the stripe's latest write), 0x00/hole =
# clean.  Degraded reads exclude marked cells from the survivor set, and
# `StorageCluster.resync` regenerates exactly the marked cells, clearing
# markers as cells come back.
EC_DIRTY_AKEY = "ec.dirty"

# The akey EC stripes live under — must match dfs.AKEY (asserted there).
EC_DATA_AKEY = "data"


@dataclass
class TargetInfo:
    target_id: int
    up: bool = True
    domain: Optional[str] = None      # fault-domain label (rack/host); None
    # on unlabeled fleets keeps placement flat


class PoolMap:
    """The versioned cluster map (DAOS pool map, shrunk to what routing
    needs): an ordered target list with up/down state, plus the per-
    container redundancy class. Every mutation bumps `version` and pushes
    to subscribed listeners (the control plane's lease-recall channel) —
    a client holding an older version is STALE and refreshes once."""

    def __init__(self):
        self.version = 1
        self.targets: List[TargetInfo] = []
        self.redundancy: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        self._listeners: List[Callable[[int], None]] = []

    def subscribe(self, cb: Callable[[int], None]) -> None:
        with self._lock:
            self._listeners.append(cb)

    def _bump(self, notify: bool = True) -> int:
        with self._lock:
            self.version += 1
            v = self.version
            listeners = list(self._listeners) if notify else []
        for cb in listeners:          # outside the lock: listeners RPC/push
            cb(v)
        return v

    def add_target(self, target_id: int,
                   domain: Optional[str] = None) -> None:
        with self._lock:
            self.targets.append(TargetInfo(target_id, domain=domain))
        self._bump()

    def set_state(self, target_id: int, up: bool, notify: bool = True) -> None:
        """Mark a target up/down and bump the map. `notify=False` models a
        LOST invalidation push (tests use it to drive the stale-map
        refresh-and-retry path): the version still moves — truth changed —
        but no client hears about it until it asks or trips."""
        with self._lock:
            for t in self.targets:
                if t.target_id == target_id:
                    t.up = up
        self._bump(notify=notify)

    def set_redundancy(self, key: str, **cls) -> None:
        with self._lock:
            self.redundancy[key] = dict(cls)
        self._bump()

    def is_up(self, target_id: int) -> bool:
        with self._lock:
            return any(t.target_id == target_id and t.up
                       for t in self.targets)

    def n_targets(self) -> int:
        with self._lock:
            return len(self.targets)

    def domain_layout(self) -> Optional[Tuple[Optional[str], ...]]:
        """Position-aligned fault-domain labels, or None when the fleet is
        unlabeled (placement stays flat)."""
        with self._lock:
            doms = tuple(t.domain for t in self.targets)
        return doms if any(d is not None for d in doms) else None

    def place(self, oid: int, dkey: str) -> Tuple[int, ...]:
        return placement_order(self.n_targets(), oid, dkey,
                               self.domain_layout())

    def describe(self) -> Dict[str, Any]:
        """Wire form of the map (what `get_pool_map` serves)."""
        with self._lock:
            return {"version": self.version,
                    "targets": [{"target_id": t.target_id, "up": t.up,
                                 "domain": t.domain}
                                for t in self.targets],
                    "redundancy": {k: dict(v)
                                   for k, v in self.redundancy.items()}}


class EngineTarget:
    """One unchanged DAOS I/O engine inside the cluster: its own device
    array, ObjectStore, and (wired by the owner) server-side memory
    registry for its data-plane session."""

    def __init__(self, target_id: int, store: ObjectStore):
        self.target_id = target_id
        self.store = store
        self.registry = None          # server MemoryRegistry (set by owner)


class _ClusterObject:
    """Fan-out facade over one oid's per-target DAOSObjects — the surface
    DFS metadata ops (truncate punch, unlink reclaim) need, fleet-wide.
    Enumerates via peek (no lazy creation on targets that never saw the
    oid)."""

    def __init__(self, cc: "ClusterContainer", oid: int):
        self.cc = cc
        self.oid = oid

    def _each(self):
        for cont in self.cc.per_target():
            obj = cont.peek_object(self.oid)
            if obj is not None:
                yield obj

    def dkeys(self, akey: str) -> List[str]:
        return sorted({dk for o in self._each() for dk in o.dkeys(akey)})

    def punch(self, dkey: str, akey: str) -> int:
        return sum(o.punch(dkey, akey) for o in self._each())

    def punch_range(self, dkey: str, akey: str, keep_upto: int) -> int:
        return sum(o.punch_range(dkey, akey, keep_upto)
                   for o in self._each())

    def punch_all(self) -> int:
        return sum(o.punch_all() for o in self._each())


class ClusterContainer:
    """One logical container spanning every engine target (same name on
    each). Data placement across the targets is the CLIENT router's job
    (algorithmic, per block); this facade carries the per-target Container
    handles plus the fleet-wide metadata ops DFS needs."""

    def __init__(self, name: str, pool: "ClusterPool",
                 params: Dict[str, Any],
                 ec: Optional[Dict[str, int]] = None):
        self.name = name
        self.pool = pool
        self.params = dict(params)
        # erasure-coded redundancy class ({"k", "p", "cell_bytes"}) — None
        # on replicated containers; the wire copy rides the pool map
        self.ec = dict(ec) if ec else None
        self._per_target: Dict[int, Container] = {}

    def target(self, target_id: int) -> Container:
        return self._per_target[target_id]

    def per_target(self) -> List[Container]:
        return [self._per_target[tid] for tid in sorted(self._per_target)]

    def object(self, oid: int) -> _ClusterObject:
        return _ClusterObject(self, oid)

    def destroy_object(self, oid: int) -> int:
        """Unlink reclaim on every target (the oid is tombstoned fleet-
        wide, so a late write through a stale route is ESTALE anywhere)."""
        return sum(c.destroy_object(oid) for c in self.per_target())


class ClusterPool:
    def __init__(self, name: str, cluster: "StorageCluster"):
        self.name = name
        self.cluster = cluster
        self.containers: Dict[str, ClusterContainer] = {}

    def create_container(self, name: str, replication: int = 2,
                         aggregate: bool = False,
                         verified_cache: bool = False,
                         write_quorum: Optional[int] = None,
                         ec: Optional[Tuple[int, int]] = None
                         ) -> ClusterContainer:
        """`ec=(k, p)` selects the erasure-coded redundancy class instead
        of replication: each block is striped as k data + p parity cells
        over k+p distinct targets, so the per-target containers hold
        SINGLE copies (replication=1 — the cross-target parity IS the
        redundancy, and the ~(k+p)/k media-byte economics depend on it)."""
        ec_cls = None
        if ec is not None:
            k, p = int(ec[0]), int(ec[1])
            if k < 1 or p < 1 or k + p > 256:
                raise ValueError(f"ec({k},{p}) outside GF(256)")
            if EC_STRIPE_BYTES % k:
                raise ValueError(
                    f"ec k={k} must divide the {EC_STRIPE_BYTES}-byte block")
            n = self.cluster.pool_map.n_targets()
            if n < k + p:
                raise ValueError(
                    f"ec({k},{p}) needs {k + p} distinct targets, have {n}")
            ec_cls = {"k": k, "p": p, "cell_bytes": EC_STRIPE_BYTES // k}
            replication, write_quorum = 1, None
        params = dict(replication=replication, aggregate=aggregate,
                      verified_cache=verified_cache,
                      write_quorum=write_quorum)
        cc = ClusterContainer(name, self, params, ec=ec_cls)
        self.containers[name] = cc
        for t in self.cluster.targets:
            self.cluster._materialize_container(cc, t)
        # the redundancy CLASS rides the pool map (clients learn it with
        # the target list, zero extra round-trips)
        if ec_cls is not None:
            self.cluster.pool_map.set_redundancy(
                f"{self.name}/{name}", ec=dict(ec_cls))
        else:
            self.cluster.pool_map.set_redundancy(
                f"{self.name}/{name}", replication=replication,
                write_quorum=write_quorum)
        return cc


class StorageCluster:
    """N independent engine targets behind one versioned pool map.

    The engines are UNCHANGED ObjectStores (the paper's design point: the
    fleet scales by adding engines, not by teaching them about each
    other); everything cluster-shaped lives here and in the client router:

      * `pool_map` — versioned target list + per-container redundancy
        class; every fail/recover/add bumps it and pushes to listeners.
      * placement — `placement_order` jump-consistent hashing shared verb-
        atim with the client, so routing needs no per-op metadata.
      * cross-target healing — an engine whose post-ack demotion finds no
        local spare escalates here and the extent is re-homed on a peer
        target (`stats.cross_target_rereplications`).
      * `resync()` — after a target recovers, extents that were written to
        failover candidates during the outage migrate back to their
        placement primary (the rebuild path's read-verify-write-punch).

    The facade also mirrors the ObjectStore surfaces fleet-level services
    consume (`containers()`, `devices`, `device()`, `csum`, `stats`), so a
    MediaScrubber pointed at the cluster scrubs every target's verified
    cache."""

    def __init__(self, n_targets: int = 1, n_devices: int = 4,
                 csum: Optional[Callable[[bytes], int]] = None,
                 timeouts: Timeouts = DEFAULT_TIMEOUTS,
                 domains: Optional[Sequence[Optional[str]]] = None,
                 device: DeviceLike = None):
        self.csum = csum or checksum
        # where the EC rebuild's parity kernel runs; not `device`, which
        # is the method that finds a storage device by name
        self.kernel_device = resolve_device(device)
        self.n_devices = int(n_devices)
        self.timeouts = timeouts
        self.faults: Optional[FaultInjector] = None
        self.pool_map = PoolMap()
        self.targets: List[EngineTarget] = []
        self.pools: Dict[str, ClusterPool] = {}
        self.stats = EngineStats()    # fleet-level events (cross-target
        self._stats_lock = threading.Lock()       # heals, cluster scrubs)
        self._cont_index: Dict[int, Tuple[ClusterContainer, int]] = {}
        # healing throttle: when a MediaScrubber is wired here, resync /
        # cross-target re-replication traffic pauses through its
        # idle-aware budget (same starvation floor as scrub cycles)
        self.heal_pacer: Optional["MediaScrubber"] = None
        self.heal_pause_s = 0.002
        self._heal_defer_streak = 0
        for i in range(n_targets):
            self.add_target(
                domain=domains[i] if domains is not None else None)

    # -- fleet membership ----------------------------------------------------
    def add_target(self, n_devices: Optional[int] = None,
                   rebalance: bool = True,
                   domain: Optional[str] = None) -> EngineTarget:
        """Bring a new (empty) engine target into the fleet: existing
        pools/containers materialize on it, the pool map bumps, and jump-
        consistent placement moves only ~1/(n+1) of the keys toward it —
        which `rebalance` (default) immediately honors by migrating those
        keys' extents onto the newcomer (the resync/rebuild path), so
        every pre-add byte stays reachable under the new map."""
        tid = len(self.targets)
        store = ObjectStore(
            make_nvme_array(n_devices or self.n_devices, prefix=f"t{tid}."),
            csum=self.csum, timeouts=self.timeouts)
        store.on_spareless_demotion = self._heal_cross_target
        if self.faults is not None:
            store.faults = self.faults
            for d in store.devices:
                d.faults = self.faults
        if self.targets:              # inherit fleet-wide engine knobs
            store.hedge_timeout_s = self.targets[0].store.hedge_timeout_s
        target = EngineTarget(tid, store)
        self.targets.append(target)
        for pool in self.pools.values():
            for cc in pool.containers.values():
                self._materialize_container(cc, target)
        self.pool_map.add_target(tid, domain=domain)
        if rebalance:
            self.resync()
        return target

    def _materialize_container(self, cc: ClusterContainer,
                               target: EngineTarget) -> None:
        store = target.store
        p = store.pools.get(cc.pool.name) or store.create_pool(cc.pool.name)
        cont = p.containers.get(cc.name) \
            or p.create_container(cc.name, **cc.params)
        cc._per_target[target.target_id] = cont
        self._cont_index[id(cont)] = (cc, target.target_id)

    def target(self, target_id: int) -> EngineTarget:
        return self.targets[target_id]

    def fail_target(self, target_id: int, notify: bool = True) -> None:
        """Administrative target-down: the map version bumps and (unless
        the push is modeled lost with notify=False) every subscribed
        client is recalled; routed ops hitting the dead target get
        TargetDownError and re-route after ONE refresh."""
        self.pool_map.set_state(target_id, False, notify=notify)

    def recover_target(self, target_id: int, resync: bool = True) -> int:
        """Re-admit a target, then `resync` (default): extents that
        failover-landed elsewhere during the outage migrate back to their
        placement primaries — computed with the recovered target ADMITTED,
        so the data moves toward it, not further away. (Reads racing the
        migration window see the pre-resync placement, as with any rebuild
        in flight.)"""
        self.pool_map.set_state(target_id, True)
        return self.resync() if resync else 0

    # -- pools/containers (ObjectStore-shaped so DFSMeta rides unchanged) ----
    def create_pool(self, name: str) -> ClusterPool:
        p = ClusterPool(name, self)
        self.pools[name] = p
        return p

    # -- fleet-wide facades (scrubber, counters) -----------------------------
    def containers(self) -> List[Container]:
        return [c for t in self.targets for c in t.store.containers()]

    @property
    def devices(self) -> List[Device]:
        return [d for t in self.targets for d in t.store.devices]

    def device(self, name: str) -> Optional[Device]:
        for t in self.targets:
            d = t.store.device(name)
            if d is not None:
                return d
        return None

    def close(self) -> None:
        for t in self.targets:
            t.store.close()

    def set_faults(self, injector: Optional[FaultInjector]) -> None:
        """Wire one fault injector through every engine target and device
        (targets added later inherit it in add_target)."""
        self.faults = injector
        for t in self.targets:
            t.store.faults = injector
            for d in t.store.devices:
                d.faults = injector

    # -- healing throttle ----------------------------------------------------
    def _pace_heal(self, nbytes: int) -> None:
        """Gate one healing transfer (resync migration / cross-target
        re-replication) on the MediaScrubber's idle-aware budget: while
        the foreground owns the array (budget squeezed to zero) the heal
        WAITS — it must still happen, reachability depends on it — up to
        the scrubber's `max_deferrals` consecutive samples, then proceeds
        anyway at the same starvation floor that bounds scrub latency.
        Deferred bytes and floor grants are counted in the fleet stats."""
        pacer = self.heal_pacer
        if pacer is None or not pacer.idle_aware:
            return
        while True:
            if pacer.idle_budget() > 0:
                self._heal_defer_streak = 0
                return
            if self._heal_defer_streak >= pacer.max_deferrals:
                self._heal_defer_streak = 0
                with self._stats_lock:
                    self.stats.heal_floor_grants += 1
                return
            self._heal_defer_streak += 1
            with self._stats_lock:
                self.stats.heal_deferrals += 1
                self.stats.deferred_heal_bytes += nbytes
            time.sleep(self.heal_pause_s)

    # -- cross-target redundancy restore -------------------------------------
    def _heal_cross_target(self, obj: DAOSObject, ext: Extent) -> None:
        """A post-ack demotion found no spare device INSIDE its engine:
        re-home the extent's payload on the first live peer target in
        placement order (read a verified surviving replica, write it into
        the peer's same (oid, dkey, akey) — the per-extent move the
        rebuild path already uses, lifted one level up)."""
        located = obj._locate_extent(ext)
        if located is None:
            return                    # punched/retired meanwhile
        dkey, akey = located
        indexed = self._cont_index.get(id(obj.container))
        if indexed is None:
            return                    # engine not part of this cluster
        cc, origin_tid = indexed
        self._pace_heal(ext.size)
        data = obj._read_extent(ext, verify=True, cache=False)
        for tid in self.pool_map.place(obj.oid, dkey):
            if tid == origin_tid or not self.pool_map.is_up(tid):
                continue
            try:
                peer = cc.target(tid)
                peer.object(obj.oid).update(dkey, akey, ext.offset,
                                            bytes(data))
            except StorageError:
                continue
            with self._stats_lock:
                self.stats.cross_target_rereplications += 1
            note_recovery(self.faults, "cluster.healed")
            return

    # -- post-recovery placement repair --------------------------------------
    def resync(self) -> int:
        """Migrate every extent living off its placement primary back home
        (read-verify from where it is, write to the primary, punch the
        stray) — the cluster-level leg of the rebuild path, run when a
        recovered target rejoins. Returns (dkey, akey) groups moved."""
        moved = 0
        n = self.pool_map.n_targets()
        doms = self.pool_map.domain_layout()
        for pool in self.pools.values():
            for cc in pool.containers.values():
                if cc.ec is not None:
                    # erasure-coded containers repair per CELL, not per
                    # first-up home: markers drive regeneration of exactly
                    # the lost cells, placement repair re-homes strays
                    moved += self._resync_ec(cc)
                    continue
                for tid in sorted(cc._per_target):
                    cont = cc._per_target[tid]
                    with cont._lock:
                        objs = list(cont._objects.items())
                    for oid, obj in objs:
                        with obj._lock:
                            keys = list(obj._extents.keys())
                        for dkey, akey in keys:
                            order = placement_order(n, oid, dkey, doms)
                            home = next((t for t in order
                                         if self.pool_map.is_up(t)), None)
                            if home is None or home == tid:
                                continue
                            moved += self._migrate(cc, obj, oid,
                                                   dkey, akey, home)
        return moved

    # -- erasure-coded rebuild (marker-driven, lost cells only) --------------
    def _ec_read_cell(self, cc: ClusterContainer, tid: int, oid: int,
                      dkey: str, cell: int, cs: int) -> np.ndarray:
        """One cell's media bytes from its engine (zeros for holes — the
        zero-pad convention parity is computed under, so sparse stripes
        decode bit-exactly)."""
        obj = cc._per_target[tid].peek_object(oid)
        if obj is None:
            return np.zeros(cs, np.uint8)
        return np.frombuffer(
            obj.fetch(dkey, EC_DATA_AKEY, cell * cs, cs), np.uint8)

    def _resync_ec(self, cc: ClusterContainer) -> int:
        """Both EC repair legs, in dependency order:

        1. REBUILD — union the fleet's dirty-cell ledgers and regenerate
           EXACTLY the marked cells whose home target is back up, from any
           k clean survivors (data cells preferred — they decode for
           free), through the scrubber-throttled heal budget.  A stripe
           below k clean up-cells keeps its markers and waits for the next
           recovery.  Markers clear per cell as it lands; an all-clean
           ledger extent is punched (leak-free).
        2. PLACEMENT REPAIR — after a target ADD shifts a stripe's
           placement order, resident cells whose home moved are re-read,
           written to the new home and punched locally (cell identity is
           self-describing via extent.offset // cell_bytes, and with
           n >= k+p each target holds at most one cell per stripe, so the
           local punch is cell-precise).

        Reconstruction runs in the MEDIA domain: parity is linear over
        what is on media (inline encryption included), so rebuild needs no
        tenant keys — the end-to-end encryption property survives server-
        side repair."""
        from repro_torch.kernels.rs_parity import ops as rs
        k, p = int(cc.ec["k"]), int(cc.ec["p"])
        cs = int(cc.ec["cell_bytes"])
        n = self.pool_map.n_targets()
        doms = self.pool_map.domain_layout()
        repaired = 0

        def attempt(fn):
            # one bounded retry: transient media anomalies clear, and a
            # persistent failure skips just this stripe (markers stay, so
            # the next resync cycle — or a degraded read — covers it)
            try:
                return fn()
            except StorageError:
                return fn()

        # -- leg 1: marker-driven regeneration -------------------------------
        dirty: Dict[Tuple[int, str], set] = {}
        for tid in sorted(cc._per_target):
            cont = cc._per_target[tid]
            with cont._lock:
                objs = list(cont._objects.items())
            for oid, obj in objs:
                for dkey in obj.dkeys(EC_DIRTY_AKEY):
                    try:
                        marks = attempt(lambda o=obj, d=dkey: o.fetch(
                            d, EC_DIRTY_AKEY, 0, k + p))
                    except StorageError:
                        continue      # unreadable ledger copy: the union
                        # of the other holders still drives this cycle,
                        # and a surviving stale mark only re-triggers an
                        # idempotent rebuild later
                    cells = {i for i, byte in enumerate(marks) if byte}
                    if cells:
                        dirty.setdefault((oid, dkey), set()).update(cells)
        for (oid, dkey), cells in sorted(dirty.items()):
            order = placement_order(n, oid, dkey, doms)
            todo = sorted(j for j in cells
                          if j < k + p and self.pool_map.is_up(order[j]))
            clean = [j for j in range(k + p) if j not in cells
                     and self.pool_map.is_up(order[j])]
            present = ([j for j in clean if j < k]
                       + [j for j in clean if j >= k])[:k]
            if not todo or len(present) < k:
                continue              # nothing rebuildable yet: keep markers
            for j in present + todo:
                self._pace_heal(cs)
            try:
                surv = np.stack([attempt(
                    lambda j=j: self._ec_read_cell(cc, order[j], oid, dkey,
                                                   j, cs))
                    for j in present])
                data = np.zeros((k, cs), np.uint8)
                for r, j in enumerate(present):
                    if j < k:
                        data[j] = surv[r]
                missing = [i for i in range(k) if i not in present]
                if missing:
                    dec = rs.ec_decode(surv, present, k, p, missing,
                                       device=self.kernel_device).cpu() \
                        .numpy()
                    for r, i in enumerate(missing):
                        data[i] = dec[r]
                parity = rs.ec_encode(data, p, device=self.kernel_device) \
                    .cpu().numpy() if any(j >= k for j in todo) else None
                for j in todo:
                    payload = data[j] if j < k else parity[j - k]
                    attempt(lambda j=j, payload=payload: cc.target(
                        order[j]).object(oid).update(
                            dkey, EC_DATA_AKEY, j * cs, payload.tobytes()))
            except StorageError:
                continue              # stripe stays marked for next cycle
            with self._stats_lock:
                self.stats.ec_rebuilt_cells += len(todo)
            repaired += len(todo)
            note_recovery(self.faults, "ec.rebuilt")
            # clear the rebuilt cells in every UP ledger; punch ledgers
            # that come up all-clean so error exits stay leak-free
            for tid in sorted(cc._per_target):
                if not self.pool_map.is_up(tid):
                    continue          # a down target's stale ledger only
                    # triggers an idempotent re-rebuild after recovery
                o2 = cc._per_target[tid].peek_object(oid)
                if o2 is None or dkey not in o2.dkeys(EC_DIRTY_AKEY):
                    continue
                try:
                    for j in todo:
                        attempt(lambda j=j: o2.update(
                            dkey, EC_DIRTY_AKEY, j, b"\x00"))
                    if not any(attempt(lambda: o2.fetch(
                            dkey, EC_DIRTY_AKEY, 0, k + p))):
                        o2.punch(dkey, EC_DIRTY_AKEY)
                except StorageError:
                    continue          # stale marks only re-trigger rebuild

        # -- leg 2: placement repair after membership change ------------------
        for tid in sorted(cc._per_target):
            if not self.pool_map.is_up(tid):
                continue
            cont = cc._per_target[tid]
            with cont._lock:
                objs = list(cont._objects.items())
            for oid, obj in objs:
                with obj._lock:
                    dkeys = sorted({dk for (dk, ak) in obj._extents
                                    if ak == EC_DATA_AKEY})
                for dkey in dkeys:
                    order = placement_order(n, oid, dkey, doms)
                    with obj._lock:
                        exts = list(obj._extents.get((dkey, EC_DATA_AKEY),
                                                     ()))
                    cells_here = sorted({e.offset // cs for e in exts})
                    stray = [i for i in cells_here if i < k + p
                             and order[i] != tid]
                    moved_all = True
                    for i in stray:
                        home = order[i]
                        if not self.pool_map.is_up(home):
                            moved_all = False
                            continue
                        self._pace_heal(cs)
                        try:
                            payload = attempt(lambda i=i: obj.fetch(
                                dkey, EC_DATA_AKEY, i * cs, cs))
                            attempt(lambda i=i, payload=payload: cc.target(
                                order[i]).object(oid).update(
                                    dkey, EC_DATA_AKEY, i * cs, payload))
                        except StorageError:
                            moved_all = False   # unreadable stray: keep it
                            continue
                        repaired += 1
                    if stray and moved_all and not any(order[i] == tid
                                                       for i in cells_here):
                        obj.punch(dkey, EC_DATA_AKEY)
        return repaired

    def _migrate(self, cc: ClusterContainer, obj: DAOSObject, oid: int,
                 dkey: str, akey: str, home_tid: int) -> int:
        with obj._lock:
            exts = list(obj._extents.get((dkey, akey), ()))
        if not exts:
            return 0
        try:
            home = cc.target(home_tid).object(oid)
            for ext in exts:          # epoch order preserved: lists are
                self._pace_heal(ext.size)
                data = obj._read_extent(ext, verify=True, cache=False)
                home.update(dkey, akey, ext.offset, bytes(data))
        except StorageError:
            return 0                  # tombstoned / unreadable: leave it
        obj.punch(dkey, akey)
        return 1


class MediaScrubber:
    """Budgeted background re-verification of verified-cache entries.

    The verified-extent cache trades a checksum pass for trust in extent
    identity; what it cannot see is in-place media corruption AFTER the
    first verify. The scrubber keeps the cache honest: each cycle it
    re-reads up to `budget_bytes` of cached replicas (round-robin across
    cycles via a rotating cursor), recomputes the Fletcher-64, and REVOKES
    any entry that no longer matches — the next foreground read then takes
    the verify-miss path and reroutes to a clean replica. Run it
    synchronously (`scrub_once`, tests/benchmarks) or as a daemon thread
    (`start(interval_s)`).

    With `idle_aware=True` the paced cycles tie their budget to device
    idle time: each cycle samples the array's recent busy-time fraction
    (per-device bytes over the same `MediaPerf` bandwidth constants the
    MVA stations use) and squeezes the byte budget linearly to ZERO at
    `util_threshold` — background re-verification only spends media
    bandwidth the foreground provably is not using, so scrubbing is free
    on loaded runs. Starvation is bounded: after `max_deferrals`
    consecutive skipped cycles a cycle runs anyway at `floor_frac` of the
    budget, so sustained load degrades the re-verification RATE but never
    unbounds the silent-corruption window the cache's honesty depends on.
    Direct `scrub_once()` calls stay unconditional (deterministic
    tests/benchmarks)."""

    def __init__(self, store: ObjectStore, budget_bytes: int = 32 << 20,
                 idle_aware: bool = False, util_threshold: float = 0.5,
                 max_deferrals: int = 8, floor_frac: float = 0.25,
                 clock: Callable[[], float] = time.monotonic,
                 device: DeviceLike = None):
        self.store = store
        self.device = resolve_device(device)   # parity scrub's kernel
        self.budget_bytes = int(budget_bytes)
        self.idle_aware = idle_aware
        self.util_threshold = float(util_threshold)
        self.max_deferrals = int(max_deferrals)
        self.floor_frac = float(floor_frac)
        self.clock = clock
        self.deferred_cycles = 0         # paced cycles skipped under load
        self._consecutive_deferrals = 0
        self._last_sample: Optional[Tuple[float, float]] = None
        self._cursor: Dict[int, int] = {}     # id(container) -> position
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- idle pacing ---------------------------------------------------------
    def device_utilization(self) -> float:
        """Busy-time fraction of the array since the previous sample: each
        device's transferred bytes over its modeled read/write bandwidth
        (MediaPerf — the same constants the MVA stations use), averaged
        across devices. The first call primes the sampler and reports
        idle."""
        now = self.clock()
        busy = sum(d.bytes_read / d.perf.read_bw
                   + d.bytes_written / d.perf.write_bw
                   for d in self.store.devices)
        last, self._last_sample = self._last_sample, (now, busy)
        if last is None or now <= last[0]:
            return 0.0
        n = max(1, len(self.store.devices))
        return (busy - last[1]) / ((now - last[0]) * n)

    def idle_budget(self) -> int:
        """This cycle's byte budget given recent utilization: the full
        budget when idle, linearly squeezed to zero at util_threshold."""
        util = self.device_utilization()
        return int(self.budget_bytes
                   * max(0.0, 1.0 - util / self.util_threshold))

    def run_paced_cycle(self) -> Dict[str, int]:
        """One pacing decision + scrub cycle — the body both the host
        daemon thread and the DPU housekeeping service run."""
        if self.idle_aware:
            budget = self.idle_budget()
            if budget <= 0:
                if self._consecutive_deferrals < self.max_deferrals:
                    self._consecutive_deferrals += 1
                    self.deferred_cycles += 1
                    return {"scanned_bytes": 0, "revoked": 0, "deferred": 1}
                # starvation bound: the foreground has pinned the array
                # for max_deferrals cycles — scrub a floor anyway
                budget = max(1, int(self.budget_bytes * self.floor_frac))
            self._consecutive_deferrals = 0
            return self.scrub_once(budget)
        return self.scrub_once()

    def scrub_once(self, budget_bytes: Optional[int] = None) -> Dict[str, int]:
        budget = self.budget_bytes if budget_bytes is None else budget_bytes
        scanned = revoked = 0
        for cont in self.store.containers():
            if scanned >= budget:
                break
            entries = cont.vcache.snapshot()
            if not entries:
                continue
            start = self._cursor.get(id(cont), 0) % len(entries)
            for i in range(len(entries)):
                if scanned >= budget:
                    break
                (name, key), (gen, csum, n) = entries[(start + i)
                                                      % len(entries)]
                self._cursor[id(cont)] = (start + i + 1) % len(entries)
                dev = self.store.device(name)
                if dev is None or not dev.alive or dev.generation != gen:
                    cont.vcache.invalidate_block(name, key)
                    continue
                try:
                    data = dev.read(key)
                except (OSError, KeyError):  # reclaimed or device failed
                    cont.vcache.invalidate_block(name, key)
                    continue
                scanned += n
                if self.store.csum(data) != csum:
                    cont.vcache.invalidate_block(name, key)
                    revoked += 1
        with self.store._stats_lock:
            self.store.stats.scrub_bytes += scanned
            self.store.stats.scrub_corruptions += revoked
        par = self.scrub_parity(budget - scanned) if scanned < budget \
            else {"scanned_bytes": 0, "parity_checks": 0,
                  "parity_mismatches": 0}
        return {"scanned_bytes": scanned + par["scanned_bytes"],
                "revoked": revoked,
                "parity_checks": par["parity_checks"],
                "parity_mismatches": par["parity_mismatches"]}

    def scrub_parity(self, budget_bytes: int) -> Dict[str, int]:
        """Parity-assisted scrub of erasure-coded stripes (the EC leg).

        Replicated containers re-read cached replicas against their
        Fletcher-64; EC stripes get a STRONGER check for the same budget
        coin: one decode-check per stripe — re-encode the k data cells
        through the rs_parity kernel and compare against the p stored
        parity cells. Per-extent checksums already catch in-place media
        rot cell by cell; what only the parity equation can see is a
        TORN stripe: a cell updated while a sibling's update was lost
        with no dirty marker (the damage a silent partial-write or a
        mis-applied delta would leave). A mismatching parity row is
        re-MARKED dirty in every UP ledger — the data cells carry their
        own checksums, so parity is the row that must re-derive — which
        makes the next resync re-encode it from the data cells and makes
        degraded reads stop trusting it immediately.

        Stripes that are legitimately inconsistent are skipped: any
        dirty marker set (a rebuild is already owed) or any home target
        down (the stripe cannot be fully read). Budget is charged at
        (k+p)*cell_bytes per checked stripe, and a rotating cursor
        spreads coverage across cycles exactly like the vcache leg, so
        parity verification rides the same idle-aware pacing. Counted in
        `engine.scrub_parity_checks` / `engine.scrub_parity_mismatches`.
        No-op when the store is not a cluster (nothing erasure-coded)."""
        store = self.store
        pm = getattr(store, "pool_map", None)
        pools = getattr(store, "pools", None)
        zero = {"scanned_bytes": 0, "parity_checks": 0,
                "parity_mismatches": 0}
        if pm is None or not pools:
            return zero
        ccs = [cc for pool in pools.values()
               for cc in pool.containers.values()
               if getattr(cc, "ec", None) is not None]
        if not ccs:
            return zero
        from repro_torch.kernels.rs_parity import ops as rs
        checks = mismatches = scanned = 0
        n = pm.n_targets()
        doms = pm.domain_layout()
        for cc in ccs:
            if scanned >= budget_bytes:
                break
            k, p = int(cc.ec["k"]), int(cc.ec["p"])
            cs = int(cc.ec["cell_bytes"])
            stripes: set = set()
            marked: set = set()
            for cont in cc.per_target():
                with cont._lock:
                    objs = list(cont._objects.items())
                for oid, obj in objs:
                    for dk in obj.dkeys(EC_DATA_AKEY):
                        stripes.add((oid, dk))
                    for dk in obj.dkeys(EC_DIRTY_AKEY):
                        if any(obj.fetch(dk, EC_DIRTY_AKEY, 0, k + p)):
                            marked.add((oid, dk))
            todo = sorted(stripes)
            if not todo:
                continue
            start = self._cursor.get(id(cc), 0) % len(todo)
            for i in range(len(todo)):
                if scanned >= budget_bytes:
                    break
                oid, dk = todo[(start + i) % len(todo)]
                self._cursor[id(cc)] = (start + i + 1) % len(todo)
                if (oid, dk) in marked:
                    continue
                order = placement_order(n, oid, dk, doms)
                if (len(order) < k + p
                        or any(not pm.is_up(order[j])
                               for j in range(k + p))):
                    continue
                try:
                    rows = np.stack([
                        store._ec_read_cell(cc, order[j], oid, dk, j, cs)
                        for j in range(k + p)])
                except StorageError:
                    continue            # a cell died under us: next cycle
                scanned += (k + p) * cs
                checks += 1
                expect = rs.ec_encode(rows[:k], p,
                                      device=self.device).cpu().numpy()
                bad = [j for j in range(p)
                       if not np.array_equal(expect[j], rows[k + j])]
                if not bad:
                    continue
                mismatches += len(bad)
                for tid in sorted(cc._per_target):
                    if not pm.is_up(tid):
                        continue
                    try:
                        cc._per_target[tid].object(oid).update_many(
                            [(dk, EC_DIRTY_AKEY, k + j, b"\x01")
                             for j in bad])
                    except StorageError:
                        continue        # a ledger holder down: union holds
        with store._stats_lock:
            store.stats.scrub_parity_checks += checks
            store.stats.scrub_parity_mismatches += mismatches
        return {"scanned_bytes": scanned, "parity_checks": checks,
                "parity_mismatches": mismatches}

    def start(self, interval_s: float = 1.0) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                self.run_paced_cycle()

        self._thread = threading.Thread(target=loop, name="media-scrub",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=DEFAULT_TIMEOUTS.thread_join_s)
        self._thread = None
