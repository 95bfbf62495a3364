"""ROS2Client: the assembled system.

    client = ROS2Client(mode="dpu", transport="rdma", n_devices=4)
    fd = client.open("/data/shard0", create=True)
    client.pwrite(fd, payload, 0)
    data = client.pread(fd, len(payload), 0)

mode="host": the DFS client runs in-process (server-grade CPU).
mode="dpu":  the DFS client runs on the SmartNIC worker pool; the host only
             rings doorbells (ROS2Client.submit/poll or the sync wrappers).
transport:   "rdma" (zero-copy, rkey-checked) or "tcp" (two-copy, segmented).

Data-path anatomy (the zero-copy path, default):

    pread:  DIRECT SPLICE (RDMA): the engine scatters the verified extent
            overlay STRAIGHT into the caller's registered region through
            the views `place_sg` hands back after validating the caller's
            destination rkey — a server-initiated RDMA WRITE. ONE copy per
            byte end-to-end, ZERO staging-ring acquires; warm re-reads
            skip the Fletcher-64 via the verified-extent cache. TCP and
            unregistered callers keep the staged path (fetch_into a ring
            slot, then the SG splice — the bounce is now counted in
            `staging.bounce_bytes`).
    pwrite: each iovec buffer registered once per writev (zero-copy wrap,
            no MR churn per block) --ONE write_sg per batch--> staging
            slots, encrypted IN PLACE (fused apply_into), then DONATED to
            every replica device under a SlotLease --update_many--> one
            epoch, one extent lock acquisition, replica commits fanned out
            ASYNCHRONOUSLY with the op returning at the container's write
            quorum (majority by default) — latency tracks the fastest
            majority; stragglers land in the background and a post-ack
            replica failure demotes + re-replicates via the rebuild path.
            Zero post-splice copies on the critical path; media writes
            back (one shared materialization per donation) under ring
            pressure or on first read. Zero control RPCs per writev: the
            size delegation defers set_size to ONE piggybacked flush at
            close_fd/fsync.
    preadv: readv_into scatters the direct splice straight into the
            per-buffer destinations — no contiguous intermediate bytes,
            no staging bounce.

Control path: session bring-up is ONE compound RPC (connect +
mount + grant_rkey), warm opens are served from the leased MetadataCache
(0 round-trips), and the staging rkey's lease is renewed before expiry —
host thread or DPU housekeeping — so long runs never hard-fault on a
lapsed capability. `legacy=True` keeps the seed's per-step control
traffic as the measured baseline.

Inline crypto (when enabled) is applied on the staging leg — the DPU-
adjacent bounce buffer — with per-block nonces and block-absolute
keystream offsets (partial-block reads decrypt at the stream position the
write used), identically on the zero-copy and legacy paths so both
interoperate on the same stored bytes. The keystream PRF is bit-identical
to the port's stream_cipher kernel (`kernels/stream_cipher`), and warm
keystream pages come from an LRU (no PRF regeneration).

`zero_copy=False` reproduces the plain scatter-gather path (tobytes per
block, verify every read, no donation, per-descriptor TCP requests);
`legacy=True` keeps the seed per-block path (one transport op + one MR
register/deregister per block, global engine lock, scalar CRC32 extent
checksums). Benchmarks measure all three in the same run, with
`_ServerIO.data_path_counters()` providing first-class copy/checksum/
keystream accounting.

Perf numbers for any workload come from `stations()` + core.sim.mva — the
same calibrated model the paper-figure benchmarks use.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict
from concurrent.futures import (CancelledError, ThreadPoolExecutor,
                                as_completed)
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.common import tracing
from repro_torch.core import transport_model as tm
from repro_torch.core import counters_registry
from repro_torch.core.control_plane import ControlPlane
from repro_torch.core.data_plane import (AccessError, MemoryRegion,
                                   MemoryRegistry, RDMATransport,
                                   TCPTransport)
from repro_torch.core.dfs import (AKEY, BLOCK, DFSClient, DFSError, DFSMeta,
                            split_blocks)
from repro_torch.core.faults import (DEFAULT_TIMEOUTS, FaultInjector,
                               InjectedTransientError, OpTimeout, Timeouts,
                               note_recovery)
from repro_torch.core.metadata_cache import MetadataCache
from repro_torch.core.media import (Device, crc32_checksum, make_nvme_array,
                              striped_stations)
from repro_torch.core.object_store import (EC_DIRTY_AKEY, MediaScrubber,
                                     ObjectStore, StorageCluster,
                                     StorageError, TargetDownError,
                                     placement_order)
from repro_torch.core.sim import Station, mva
from repro_torch.core.smartnic import DPURuntime, InlineCrypto
from repro_torch.device import DeviceLike, resolve_device


def merge_counters(dicts: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Fleet-aware counter merge: sum numeric leaves across a sequence of
    (possibly nested) counter dicts, recursing into sub-dicts; the first
    occurrence wins for non-numeric values. This is THE counter-merge used
    everywhere counters from more than one source meet — the cluster
    router merging per-target sessions, and the benchmarks merging run
    deltas (benchmarks/common.py re-exports it)."""
    out: Dict[str, Any] = {}
    for d in dicts:
        for k, v in d.items():
            if isinstance(v, dict):
                out[k] = merge_counters([out.get(k, {}), v])
            elif isinstance(v, bool) or not isinstance(v, (int, float)):
                out.setdefault(k, v)
            else:
                out[k] = out.get(k, 0) + v
    return out


class SlotLease:
    """Lease on a DONATED staging-ring slot.

    The op thread holds the slot while staging; at commit each replica
    device `pin()`s the lease (the buffer is now media's DMA source) and
    `unpin()`s it when its deferred writeback lands the bytes (or the
    block is deleted). The slot returns to the ring's free list only when
    the op has released it AND every pin has dropped — a donated slot can
    therefore never be re-staged while any device still reads from it
    (the no-aliasing invariant tests assert structurally)."""

    __slots__ = ("ring", "slot", "materialized", "_pins", "_op_held",
                 "_freed", "_lock")

    def __init__(self, ring: "_StagingRing", slot: int):
        self.ring = ring
        self.slot = slot
        # first replica writeback materializes the payload once; the other
        # replicas reuse it (the replicas all DMA from the same buffer)
        self.materialized: Optional[bytes] = None
        self._pins = 0
        self._op_held = True
        self._freed = False
        self._lock = threading.Lock()

    def pin(self) -> None:
        with self._lock:
            assert not self._freed, "pin on a returned slot lease"
            self._pins += 1

    def unpin(self) -> None:
        with self._lock:
            self._pins -= 1
            free_now = self._pins == 0 and not self._op_held \
                and not self._freed
            if free_now:
                self._freed = True
        if free_now:
            self.ring._return_slot(self.slot)

    def _op_release(self) -> None:
        with self._lock:
            self._op_held = False
            free_now = self._pins == 0 and not self._freed
            if free_now:
                self._freed = True
        if free_now:
            self.ring._return_slot(self.slot)

    @property
    def active(self) -> bool:
        with self._lock:
            return not self._freed


class _StagingRing:
    """N block-sized staging slots in ONE registered server region.

    Slot ownership is per-slot (a Lock each); `acquire(k)` hands out k free
    slots atomically (waits until k are free at once, so concurrent multi-
    slot ops can never deadlock holding partial sets). This replaces the
    seed's single 4-block staging region guarded by a global engine lock —
    with 16 slots, 16 DPU workers stage in parallel.

    `donate(slot)` starts the zero-copy write handoff: the slot's buffer
    becomes the payload media commits by reference (SlotLease above). When
    `acquire` runs short of free slots and donations are outstanding, it
    invokes the reclaim callback (the server flushes device writebacks) to
    pull leased slots back instead of waiting out their owners."""

    def __init__(self, registry: MemoryRegistry, n_slots: int,
                 slot_bytes: int, tenant: str,
                 timeouts: Timeouts = DEFAULT_TIMEOUTS,
                 label: Optional[str] = None):
        self.n_slots = max(1, int(n_slots))
        self.slot_bytes = int(slot_bytes)
        self.timeouts = timeouts
        self.label = label            # op context for timeout errors
        self.region = registry.register(self.n_slots * self.slot_bytes,
                                        tenant)
        self._locks = [threading.Lock() for _ in range(self.n_slots)]
        self._free = list(range(self.n_slots))
        self._cv = threading.Condition()
        self._donated: Dict[int, SlotLease] = {}
        self._reclaim = None          # callback: flush media writebacks
        self.donations = 0
        self.reclaims = 0
        self.acquires = 0             # slot-batch acquisitions (bounce gauge:
        # steady-state direct-splice reads must never touch the ring)

    def set_reclaim(self, cb) -> None:
        self._reclaim = cb

    def acquire(self, k: int, timeout: Optional[float] = None) -> List[int]:
        k = min(k, self.n_slots)
        if timeout is None:
            timeout = self.timeouts.staging_acquire_s
        import time as _time
        start = _time.monotonic()
        deadline = start + timeout
        while True:
            with self._cv:
                if len(self._free) >= k:
                    slots = [self._free.pop() for _ in range(k)]
                    break
                reclaimable = bool(self._donated) and self._reclaim is not None
                if not reclaimable:
                    if not self._cv.wait(deadline - _time.monotonic()):
                        raise OpTimeout(
                            "staging.acquire", target=self.label,
                            elapsed_s=_time.monotonic() - start,
                            detail=f"ring exhausted ({k} slots wanted, "
                                   f"{len(self._free)} free)")
                    continue
            # leased slots outstanding: ask media to write back (outside
            # the cv — writeback completion re-enters via _return_slot);
            # bounded to roughly what this acquire needs, not a full flush
            self.reclaims += 1
            self._reclaim(k * self.slot_bytes)
            with self._cv:
                if len(self._free) >= k:
                    slots = [self._free.pop() for _ in range(k)]
                    break
                if _time.monotonic() >= deadline:
                    raise OpTimeout(
                        "staging.acquire", target=self.label,
                        elapsed_s=_time.monotonic() - start,
                        detail=f"ring exhausted ({k} slots wanted, "
                               f"{len(self._free)} free, "
                               f"{len(self._donated)} donated)")
                self._cv.wait(self.timeouts.poll_interval_s)
        for s in slots:
            acquired = self._locks[s].acquire(blocking=False)
            assert acquired, "staging slot handed out twice"
        with self._cv:
            self.acquires += 1
        return slots

    def donate(self, slot: int) -> SlotLease:
        lease = SlotLease(self, slot)
        with self._cv:
            self._donated[slot] = lease
            self.donations += 1
        return lease

    def release(self, slots: List[int]) -> None:
        for s in slots:               # locks first: a slot must never sit
            self._locks[s].release()  # in _free with its lock still held
        donated: List[SlotLease] = []
        with self._cv:
            back = []
            for s in slots:
                lease = self._donated.get(s)
                if lease is None:
                    back.append(s)
                else:
                    donated.append(lease)
            self._free.extend(back)
            self._cv.notify_all()
        for lease in donated:
            lease._op_release()

    def _return_slot(self, slot: int) -> None:
        with self._cv:
            self._donated.pop(slot, None)
            self._free.append(slot)
            self._cv.notify_all()

    def donated_slots(self) -> List[int]:
        with self._cv:
            return sorted(self._donated)

    def offset(self, slot: int) -> int:
        return slot * self.slot_bytes

    def view(self, slot: int) -> np.ndarray:
        off = slot * self.slot_bytes
        return self.region.buf[off:off + self.slot_bytes]


def _chain(fn: Callable[[], Any],
           then: Optional[Callable[[Any], Any]]) -> Callable[[], Any]:
    """Compose a post-processing step INTO the submitted op so it runs on
    the executing thread (inside the op's own resource scope), never at
    reap time under the CQ lock — a `_then` that does control RPCs (the
    DFS size delegation) must not nest inside the CQ condition variable."""
    if then is None:
        return fn

    def run() -> Any:
        return then(fn())
    return run


class CompletionHandle:
    """A lightweight completion token for one submitted op — the WR the
    caller keeps after posting to the SQ. States move strictly
    pending -> running -> done|error, or pending -> cancelled, all under
    the owning completion queue's condition variable. The op function owns
    every resource it touches via its own try/finally (slots, leases,
    rkeys, SQ ring slot), so a handle abandoned after `wait()` times out
    cannot leak: the op drains in the background and releases on its own
    exit path, exactly once."""

    def __init__(self, cq: "_CompletionQueue", op: str,
                 fn: Callable[[], Any],
                 deadline_s: Optional[float] = None):
        self._cq = cq
        self.op = op
        self._fn = fn
        self._state = "pending"
        self._result: Any = None
        self._error: Optional[BaseException] = None
        self._reaped = False
        self._t0 = time.monotonic()
        self._deadline_s = deadline_s
        cq._register(self)

    def _run(self) -> None:
        cq = self._cq
        with cq._cv:
            if self._state != "pending":
                return                # cancelled before a worker picked it up
            self._state = "running"
        try:
            res = self._fn()
        except Exception as e:  # lint: allow(broad-except): not a swallow —
            # the failure is STORED on the handle and re-raised verbatim at
            # wait(); resource release already ran in the op's own
            # try/finally on this thread
            cq._settle(self, error=e)
            return
        cq._settle(self, result=res)

    def cancel(self) -> bool:
        """Cancel iff still pending (never dispatched). A running op is
        already holding resources mid-verb and must drain; reap it or
        abandon it — either way its own try/finally releases."""
        cq = self._cq
        with cq._cv:
            if self._state != "pending":
                return False
            self._state = "cancelled"
        cq._settle(self, cancelled=True)
        return True

    def done(self) -> bool:
        with self._cq._cv:
            return self._state not in ("pending", "running")

    def wait(self, timeout: Optional[float] = None) -> Any:
        """Reap this op: block until it settles, then return its result or
        re-raise its error. The deadline is measured from SUBMIT time
        under the injectable Timeouts policy (explicit `timeout` wins,
        then the per-handle deadline, then `timeouts.op_deadline_s`).
        Deadline expiry on a still-pending handle cancels it in place;
        on a running handle it abandons it (OpTimeout) with the completion
        draining in the background."""
        cq = self._cq
        budget = timeout if timeout is not None else self._deadline_s
        if budget is None:
            budget = cq.timeouts.op_deadline_s
        deadline = self._t0 + budget
        with cq._cv:
            while self._state in ("pending", "running"):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                cq._cv.wait(remaining)
            state = self._state
        if state == "pending":
            if self.cancel():
                raise OpTimeout(self.op,
                                elapsed_s=time.monotonic() - self._t0,
                                detail="deadline before dispatch; "
                                       "handle cancelled in place")
            return self.wait(timeout)   # lost the race with _run: settled
        if state == "running":
            raise OpTimeout(self.op, elapsed_s=time.monotonic() - self._t0,
                            detail="op still in flight; completion drains "
                                   "in background")
        return self._reap()

    # concurrent.futures-flavoured alias so handles drop into code written
    # against Future-shaped objects
    def result(self, timeout: Optional[float] = None) -> Any:
        return self.wait(timeout)

    def _reap(self) -> Any:
        cq = self._cq
        with cq._cv:
            first = not self._reaped
            self._reaped = True
            cq._done.pop(self, None)
            state, err, res = self._state, self._error, self._result
        if first:
            cq._note_reap()
        if state == "cancelled":
            raise CancelledError(self.op)
        if err is not None:
            raise err
        return res


class _CompletionQueue:
    """THE shared per-client completion queue all submitted ops drain
    into. Caller-reaped — like polling a hardware CQ, the reap logic runs
    on whichever thread calls wait()/drain(); there is no dedicated reaper
    thread to leak or deadlock. One condition variable orders every handle
    state transition and carries the counters the registry declares under
    `cq.*`."""

    def __init__(self, timeouts: Timeouts = DEFAULT_TIMEOUTS):
        self.timeouts = timeouts
        self._cv = threading.Condition()
        self._inflight: set = set()
        # settled-but-unreaped handles in completion order — the poll()
        # list. Ordered-set shape (OrderedDict keys) so a wait()-side reap
        # retires its handle in O(1) instead of scanning a deque.
        self._done: "OrderedDict[CompletionHandle, None]" = OrderedDict()
        self.submitted = 0
        self.completed = 0
        self.cancelled = 0
        self.inflight_peak = 0
        self.reap_batches = 0

    def _register(self, h: CompletionHandle) -> None:
        with self._cv:
            self.submitted += 1
            self._inflight.add(h)
            if len(self._inflight) > self.inflight_peak:
                self.inflight_peak = len(self._inflight)

    def _settle(self, h: CompletionHandle, result: Any = None,
                error: Optional[BaseException] = None,
                cancelled: bool = False) -> None:
        with self._cv:
            if cancelled:
                self.cancelled += 1
            else:
                h._result = result
                h._error = error
                h._state = "error" if error is not None else "done"
                self.completed += 1
            self._inflight.discard(h)
            self._done[h] = None
            self._cv.notify_all()

    def _note_reap(self) -> None:
        with self._cv:
            self.reap_batches += 1

    def inflight(self) -> int:
        with self._cv:
            return len(self._inflight)

    def counters(self) -> Dict[str, int]:
        with self._cv:
            return {"submitted": self.submitted,
                    "completed": self.completed,
                    "inflight_peak": self.inflight_peak,
                    "reap_batches": self.reap_batches,
                    "cancelled": self.cancelled}

    def poll(self, n: Optional[int] = None) -> List[CompletionHandle]:
        """Non-blocking CQ poll: pop up to `n` settled-but-unreaped handles
        (all of them when `n` is None) in COMPLETION order — the hardware
        polling idiom, so callers reap out of submission order. Returned
        handles are settled: `wait()` on each returns (or re-raises) without
        blocking. A handle already reaped via wait()/result() never appears;
        popping here does not mark the handle reaped (the caller's wait()
        still owns result/error delivery and the reap-batch count)."""
        out: List[CompletionHandle] = []
        with self._cv:
            while self._done and (n is None or len(out) < n):
                h, _ = self._done.popitem(last=False)
                out.append(h)
        return out

    def wait_any(self, handles: Sequence[CompletionHandle],
                 timeout: Optional[float] = None) -> List[CompletionHandle]:
        """Block until AT LEAST one of `handles` settles; return every
        settled one, completion-order agnostic and WITHOUT reaping (callers
        wait() each returned handle to consume its result or error). The
        out-of-order window primitive: a striped reader holding `depth`
        outstanding reads retires whichever finished first instead of
        head-of-line blocking on submission order. Timeout defaults to the
        injectable op deadline; expiry raises OpTimeout without cancelling
        anything."""
        if not handles:
            return []
        budget = timeout if timeout is not None else self.timeouts.op_deadline_s
        deadline = time.monotonic() + budget
        with self._cv:
            while True:
                done = [h for h in handles
                        if h._state not in ("pending", "running")]
                if done:
                    return done
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise OpTimeout("cq.wait_any", elapsed_s=budget,
                                    detail=f"none of {len(handles)} handles "
                                           "settled before deadline")
                self._cv.wait(remaining)

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every in-flight handle settles (close path)."""
        if timeout is None:
            timeout = self.timeouts.drain_s
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise OpTimeout("cq.drain", elapsed_s=timeout,
                                    detail=f"{len(self._inflight)} handles "
                                           "still in flight at drain "
                                           "deadline")
                self._cv.wait(remaining)


class _SubmissionRing:
    """Per-target SQ depth bound: at most `depth` ops of one target
    execute at once — the verbs/io_uring submission-queue semantics. The
    slot is taken by the EXECUTING thread (inside the op wrapper), not at
    submit, so submitters never block, pending handles stay cancellable,
    and `io_depth` bounds running ops per target."""

    def __init__(self, depth: int, timeouts: Timeouts = DEFAULT_TIMEOUTS):
        self.depth = max(1, int(depth))
        self.timeouts = timeouts
        self._cv = threading.Condition()
        self._inflight = 0
        self.peak = 0

    def acquire(self, timeout: Optional[float] = None) -> None:
        if timeout is None:
            timeout = self.timeouts.op_deadline_s
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._inflight >= self.depth:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise OpTimeout("sq.acquire", elapsed_s=timeout,
                                    detail=f"submission ring full at depth "
                                           f"{self.depth}")
                self._cv.wait(remaining)
            self._inflight += 1
            if self._inflight > self.peak:
                self.peak = self._inflight

    def release(self) -> None:
        with self._cv:
            self._inflight -= 1
            self._cv.notify()


class _SubmitReap:
    """Submit/reap plumbing shared by _ServerIO and _ClusterRouter: a lazy
    dispatch pool feeds ops into the shared _CompletionQueue; subclasses
    override `_sq_ring()` to bound in-flight depth (the router bounds
    per-target inside `_run_batch` instead). `_inline=True` runs the op on
    the calling thread — the synchronous API is exactly submit + wait with
    inline execution, so results are bit-identical to the old blocking
    path while still flowing through full CQ accounting."""

    def _init_submit(self, io_depth: int,
                     timeouts: Timeouts = DEFAULT_TIMEOUTS) -> None:
        self.io_depth = max(1, int(io_depth))
        self.cq = _CompletionQueue(timeouts)
        self._submit_pool: Optional[ThreadPoolExecutor] = None
        self._submit_pool_lock = threading.Lock()

    def _sq_ring(self) -> Optional[_SubmissionRing]:
        return None

    def _get_submit_pool(self) -> ThreadPoolExecutor:
        with self._submit_pool_lock:
            if self._submit_pool is None:
                self._submit_pool = ThreadPoolExecutor(
                    max_workers=max(2, self.io_depth),
                    thread_name_prefix="cq-submit")
            return self._submit_pool

    def _submit(self, op: str, fn: Callable[[], Any],
                timeout: Optional[float] = None,
                inline: bool = False) -> CompletionHandle:
        ring = self._sq_ring()
        if ring is None:
            run = fn
        else:
            def run() -> Any:
                ring.acquire()
                try:
                    return fn()
                finally:
                    ring.release()
        h = CompletionHandle(self.cq, op, run, deadline_s=timeout)
        if inline:
            h._run()
        else:
            # the handle IS the completion token; the executor Future is
            # redundant with it
            self._get_submit_pool().submit(h._run)
        return h

    def _close_submit(self) -> None:
        """Drain the CQ then retire the dispatch pool — every in-flight
        handle settles (releasing its slots/leases/rkeys on its own exit
        path) before teardown proceeds."""
        self.cq.drain()
        with self._submit_pool_lock:
            pool, self._submit_pool = self._submit_pool, None
        if pool is not None:
            pool.shutdown(wait=True)


class _ServerIO(_SubmitReap):
    """ONE engine target's data-plane session (and, for a single-target
    deployment, the whole transport-aware I/O adapter DFSClient uses).
    Each session owns its target's staging ring, transport endpoint and
    rkey grants; a multi-target client runs one per target behind a
    _ClusterRouter that stripes block ranges across them.

    Default path is vectored: `writev`/`read_into` coalesce the
    `split_blocks` output into one scatter-gather transport op per staging
    batch, stage through the per-slot-locked ring (no global lock), and
    commit/fetch through the engine's batched `update_many`/`fetch_into`.
    `legacy=True` preserves the seed per-block path for comparison.

    `target_up` (cluster sessions) is the server-side admission check: an
    op routed here by a STALE client map while the pool map says this
    target is down raises TargetDownError before touching any state — the
    router reacts with one map refresh and a re-route.

    Concurrency semantics: with the global lock gone, overlapping reads
    and writes from different callers are NOT atomic against each other —
    a reader racing a multi-block writer may observe some blocks from the
    new write and some from the old state (each block individually
    consistent via epochs). This matches POSIX/DFS practice for
    unsynchronized overlapping I/O; callers needing read-vs-write
    atomicity must serialize at the application layer."""

    def __init__(self, engine_container, client_registry: MemoryRegistry,
                 server_registry: MemoryRegistry, transport: str,
                 tenant: str, control: ControlPlane,
                 crypto: Optional[InlineCrypto] = None,
                 n_staging_slots: int = 16, legacy: bool = False,
                 zero_copy: bool = True,
                 target_up: Optional[Callable[[], bool]] = None,
                 faults: Optional[FaultInjector] = None,
                 timeouts: Timeouts = DEFAULT_TIMEOUTS,
                 label: Optional[str] = None,
                 io_depth: int = 16, tcp_registered: bool = False):
        self.container = engine_container
        self._target_up = target_up
        self._faults = faults
        self.timeouts = timeouts
        self.label = label
        self.creg = client_registry
        self.sreg = server_registry
        self.tenant = tenant
        self.cp = control
        self.crypto = crypto
        self.transport_kind = transport
        self.legacy = legacy
        self.zero_copy = zero_copy and not legacy
        # direct read splice: server-initiated placement straight into the
        # caller's registered destination (RDMA only — TCP has no way to
        # land bytes in caller memory without the kernel staging them)
        self.direct_reads = self.zero_copy and transport == "rdma"
        self.host_copy_bytes = 0      # client-side materialization copies
        self.bounce_bytes = 0         # engine->ring staging on STAGED reads
        # destination-capability cache: one granted rkey per registered
        # destination region, reused across reads (persistent
        # registrations — device-direct rings — never re-grant; leases
        # are renewed IN PLACE inside a skew margin, so a sink that
        # outlives the TTL never presents an expired capability)
        self._dst_rkeys: "OrderedDict[int, Tuple[str, MemoryRegion, float]]"\
            = OrderedDict()
        self._dst_rkey_ttl = 3600.0
        self._dst_rkey_lock = threading.Lock()
        # server staging ring (bounce buffers) for the engine side; the
        # legacy path uses the same region through `self.staging`
        self.ring = _StagingRing(self.sreg, n_staging_slots, BLOCK, tenant,
                                 timeouts=timeouts, label=label)
        self.staging = self.ring.region
        if self.zero_copy:
            self.ring.set_reclaim(self._reclaim_donations)
        self.tcp_registered = tcp_registered and transport != "rdma"
        if transport == "rdma":
            self.xport = RDMATransport(local=self.creg, remote=self.sreg)
        else:
            self.xport = TCPTransport(local=self.creg, remote=self.sreg,
                                      sendmsg_batching=self.zero_copy,
                                      registered=self.tcp_registered)
        self.xport.faults = faults
        # submit/reap state: shared CQ + this target's submission ring
        self._init_submit(io_depth, timeouts)
        self.sq = _SubmissionRing(self.io_depth, timeouts)
        # capability exchange happens in the owner's bring-up compound
        # (ROS2Client) — attach_session hands us the session + staging rkey
        self._sid: Optional[int] = None
        self.staging_rkey: Optional[str] = None
        self.cache = None               # MetadataCache (rkey lease watch)
        self._lock = threading.Lock()           # legacy path only
        # concurrency gauge: how many reads are in flight right now / ever
        self._gauge_lock = threading.Lock()
        self._active_reads = 0
        self.max_concurrent_reads = 0

    def attach_session(self, session_id: int, rkey: Optional[str] = None,
                       rkey_ttl_s: Optional[float] = None,
                       cache=None) -> None:
        """Adopt the control-plane session (and, over RDMA, the staging
        rkey) the owner established — in the compound bring-up, connect +
        mount + grant_rkey arrive in ONE round-trip and this wires the
        results in. The cache tracks the rkey's lease so it is renewed
        BEFORE expiry instead of hard-faulting mid-run."""
        self._sid = session_id
        self.cache = cache
        if rkey is not None:
            self.staging_rkey = rkey
            if cache is not None and rkey_ttl_s is not None:
                cache.put_rkey(rkey, rkey_ttl_s)

    def _staging_token(self) -> str:
        """Hot-path rkey accessor: one dict-lookup freshness check; the
        slow path (lease inside its skew margin) renews synchronously so
        the data plane NEVER presents an expired capability."""
        tok = self.staging_rkey
        if self.cache is not None and not self.cache.rkey_fresh(tok):
            self.cache.renew_due()
        return tok

    def _admit(self) -> None:
        """Server-side admission: reject ops a stale client map routed to
        a target the pool map marks down (one refresh fixes the client)."""
        if self._target_up is not None and not self._target_up():
            raise TargetDownError("engine target is down in the pool map")
        # injected target crash mid-op: the engine dies AFTER admission —
        # exactly the window the router's surgical retry must cover
        if self._faults is not None \
                and self._faults.pick("engine.crash", target=self.label) \
                is not None:
            raise TargetDownError(
                f"injected target crash mid-op ({self.label})")

    def _note_recovery(self, path: str) -> None:
        note_recovery(self._faults, path)

    def _maybe_expire_cap(self) -> None:
        """Injected premature rkey expiry: the SERVER-side lease on our
        staging rkey lapses under us (clock skew / recalled lease), so the
        next SG op fails the transport's real capability check with
        AccessError — recovery is the renew_rkey control RPC + one retry
        (`_xport_op` below), never a bypass of the check itself."""
        if self._faults is None or self.staging_rkey is None:
            return
        if self._faults.pick("cap.expire", target=self.label) is None:
            return
        ent = self.sreg._rkeys.get(self.staging_rkey)
        if ent is not None:
            ent.expires_at = 0.0

    def _renew_staging_rkey(self) -> bool:
        """Recover a lapsed staging capability through the control plane
        (the same renew_rkey RPC lease renewal uses)."""
        if self._sid is None or self.staging_rkey is None:
            return False
        r = self.cp.rpc("renew_rkey", session_id=self._sid,
                        rkey=self.staging_rkey, ttl_s=3600.0)
        return bool(r.get("ok"))

    def _xport_op(self, fn):
        """Run one SG transport op with surgical fault recovery:

        * InjectedTransientError — a wire-level fault (the RC QP would
          retransmit); the SG ops are idempotent (same descriptors, same
          bytes), so a bounded run of immediate retransmits is the
          recovery (budget shared with the cluster retry policy).
        * AccessError — the staging capability lapsed (premature expiry);
          renew it via the control plane and retry once. A renewal refusal
          (revoked key) re-raises — capabilities are never bypassed.
        """
        retransmits = 0
        while True:
            try:
                out = fn()
            except InjectedTransientError:
                retransmits += 1
                if retransmits > max(1, self.timeouts.retry_budget):
                    raise
                continue
            except AccessError:
                if not self._renew_staging_rkey():
                    raise
                out = fn()
                self._note_recovery("cap.renewed")
                return out
            if retransmits:
                self._note_recovery("transport.retry")
            return out

    @property
    def stats(self):
        return self.xport.stats

    def _reclaim_donations(self, need_bytes: Optional[int] = None) -> None:
        """Staging-ring pressure: flush media writebacks so leased slots
        return to the free list (invoked by ring.acquire). Every replica
        device must release its pin for a slot to come back, so the bound
        applies per device; the shared-materialization on the lease keeps
        that at one copy per donated byte total."""
        for dev in self.container.store.devices:
            dev.writeback(limit_bytes=need_bytes)

    def data_path_counters(self) -> Dict[str, Any]:
        """First-class copy/checksum/keystream accounting across the whole
        data path: transport (wire), engine (checksum + verified cache),
        media (commit copies vs donations), client (materializations) and
        crypto (keystream cache). The benchmark's copies/byte, checksum
        hit rate and keystream hit rate all derive from this one dict."""
        from dataclasses import asdict
        store = self.container.store
        devs = store.devices
        out = {
            "transport": asdict(self.xport.stats),
            "engine": asdict(store.stats),
            "media": {
                "host_copy_bytes": sum(d.host_copy_bytes for d in devs),
                "donated_bytes": sum(d.donated_bytes for d in devs),
                "writeback_bytes": sum(d.writeback_bytes for d in devs),
                "bytes_written": sum(d.bytes_written for d in devs),
                "bytes_read": sum(d.bytes_read for d in devs),
            },
            "client": {"host_copy_bytes": self.host_copy_bytes},
            "staging": {"donations": self.ring.donations,
                        "reclaims": self.ring.reclaims,
                        "acquires": self.ring.acquires,
                        "bounce_bytes": self.bounce_bytes},
            # submit/reap accounting for the shared completion queue
            "cq": self.cq.counters(),
            # the control path is a measured subsystem, not an uncounted
            # tax: round-trips, payload bytes, compound batching and lease
            # traffic all show up next to the per-byte data-plane costs
            "control": {"rpc_count": self.cp.rpc_count,
                        "rpc_bytes": self.cp.rpc_bytes,
                        "compound_ops": self.cp.compound_ops,
                        "invalidations_sent": self.cp.invalidations_sent},
        }
        if self.cache is not None:
            out["meta_cache"] = asdict(self.cache.stats)
        if self.crypto is not None:
            out["crypto"] = asdict(self.crypto.stats)
        if self._faults is not None:
            # every injection and every recovery path taken, first-class
            # next to the costs they perturb (injector shared fleet-wide —
            # the router reports it once, not summed per session)
            out["faults"] = self._faults.counters()
        return counters_registry.verify(out)

    # -- vectored write path -------------------------------------------------
    def write(self, oid: int, offset: int, data) -> None:
        if self.legacy:
            self._write_legacy(oid, offset, data)
        else:
            self.writev(oid, offset, [data])

    def writev(self, oid: int, offset: int, buffers: Sequence) -> int:
        """Blocking vectored write — submit + wait with inline execution
        (bit-identical to the pre-async path; see `_writev_impl` for the
        data-plane mechanics)."""
        return self.submit_writev(oid, offset, buffers, _inline=True).wait()

    def _writev_impl(self, oid: int, offset: int, buffers: Sequence) -> int:
        """Scatter-gather write: every iovec buffer is registered once
        (zero-copy wrap, no concatenation), moved in ring-sized SG batches
        (one transport op each, descriptors pointing into the caller's own
        regions), and committed via `update_many` (one epoch per writev).

        On the zero-copy path the staged block is encrypted IN PLACE
        (fused `apply_into`, no temporary) and its ring slot DONATED to
        media: every replica commits the buffer by reference under a
        SlotLease, so the op-critical path performs zero post-splice
        copies; media's deferred writeback (pressure/read-triggered) pays
        the NAND program later. With `zero_copy=False` the sg-path behavior
        (one `tobytes` materialization per block) is preserved."""
        if self.legacy:
            pos = offset
            for a in buffers:
                b = bytes(a)
                self._write_legacy(oid, pos, b)
                pos += len(b)
            return pos - offset
        self._admit()
        arrs = [a if isinstance(a, np.ndarray)
                else np.frombuffer(bytes(a), np.uint8) for a in buffers]
        arrs = [a for a in arrs if a.size]
        total = int(sum(a.size for a in arrs))
        if total == 0:
            return 0
        obj = self.container.object(oid)
        mrs = [self.creg.register(a, self.tenant) for a in arrs]
        # buffer spans in writev-global byte coordinates
        spans, g = [], 0
        for mr in mrs:
            spans.append((g, g + mr.size, mr))
            g += mr.size
        epoch = self.container.next_epoch()
        try:
            blocks = split_blocks(offset, total)
            pos = 0
            si = 0          # span cursor: spans and blocks both ascend
            for base in range(0, len(blocks), self.ring.n_slots):
                batch = blocks[base:base + self.ring.n_slots]
                slots = self.ring.acquire(len(batch))
                try:
                    iov, p = [], pos
                    for (b, bo, ln), s in zip(batch, slots):
                        # a block may straddle buffer boundaries: one
                        # descriptor per (block, buffer) overlap —
                        # two-pointer walk, O(blocks + buffers) overall
                        while si < len(spans) and spans[si][1] <= p:
                            si += 1
                        j = si
                        while j < len(spans) and spans[j][0] < p + ln:
                            g0, g1, mr = spans[j]
                            lo, hi = max(p, g0), min(p + ln, g1)
                            iov.append((self.ring.offset(s) + lo - p,
                                        mr, lo - g0, hi - lo))
                            j += 1
                        p += ln
                    if self.transport_kind == "rdma":
                        self._maybe_expire_cap()
                        self._xport_op(lambda: self.xport.write_sg(
                            self._staging_token(), self.tenant, iov))
                    else:
                        self._xport_op(
                            lambda: self.xport.write_sg(self.staging, iov))
                    items, leases = [], []
                    for (b, bo, ln), s in zip(batch, slots):
                        view = self.ring.view(s)[:ln]
                        if self.crypto is not None:
                            if self.zero_copy:      # fused in-place XOR
                                self.crypto.apply_into(
                                    view, view, nonce=oid * (1 << 20) + b,
                                    offset=bo)
                            else:
                                view[:] = self.crypto.apply(
                                    view, nonce=oid * (1 << 20) + b,
                                    offset=bo)
                        if self.zero_copy:
                            items.append((str(b), AKEY, bo, view))
                            leases.append(self.ring.donate(s))
                        else:
                            items.append((str(b), AKEY, bo, view.tobytes()))
                            leases.append(None)
                            with self._gauge_lock:   # concurrent DPU writers
                                self.host_copy_bytes += ln
                    obj.update_many(items, epoch=epoch, leases=leases)
                    pos = p
                finally:
                    self.ring.release(slots)
        finally:
            for mr in mrs:
                self.creg.deregister(mr)
        return total

    # -- vectored read path --------------------------------------------------
    def _fetch_block(self, obj, oid: int, b: int, bo: int, ln: int,
                     view: np.ndarray) -> None:
        """Stage one block: engine -> ring slot (tests hook this to assert
        staging-ring concurrency). This bounce is a real host copy the
        direct-splice path eliminates — counted in `bounce_bytes` so
        copies/byte stays honest on the staged path. Decrypt is the fused
        single-pass `apply_into` on the zero-copy path (the sg path's
        generate+XOR+copy-back is kept behind `zero_copy=False`)."""
        with tracing.span("session.fetch"):
            obj.fetch_into(str(b), AKEY, bo, ln, view)
        with self._gauge_lock:
            self.bounce_bytes += ln
        if self.crypto is not None:
            if self.zero_copy:
                self.crypto.apply_into(view[:ln], view[:ln],
                                       nonce=oid * (1 << 20) + b, offset=bo)
            else:
                view[:ln] = self.crypto.apply(view[:ln],
                                              nonce=oid * (1 << 20) + b,
                                              offset=bo)

    @property
    def supports_readv_into(self) -> bool:
        return self.zero_copy

    def readv_into(self, oid: int, offset: int, bufs: Sequence) -> int:
        """Blocking vectored gather-read — submit + wait with inline
        execution (bit-identical; see `_readv_into_impl`)."""
        return self.submit_readv_into(oid, offset, bufs,
                                      _inline=True).wait()

    def _readv_into_impl(self, oid: int, offset: int,
                         bufs: Sequence) -> int:
        """Vectored gather-read filling N caller buffers (np.uint8 arrays)
        directly from the contiguous file range [offset, offset+total) —
        the `preadv` fast path. Each buffer is registered once (zero-copy
        wrap) and the SG descriptors scatter straight into them; no
        contiguous intermediate `bytes` is ever materialized."""
        mrs = [self.creg.register(b, self.tenant) for b in bufs]
        try:
            return self._gather_into(
                oid, offset, [(mr, 0, mr.size) for mr in mrs])
        finally:
            for mr in mrs:
                self.drop_dst_rkey(mr)    # per-op capability dies with MR
                self.creg.deregister(mr)

    def read_into(self, oid: int, offset: int, size: int,
                  dst_mr: MemoryRegion, dst_off: int = 0) -> int:
        """Blocking device-direct read — submit + wait with inline
        execution (bit-identical; see `_read_into_impl`)."""
        return self.submit_read_into(oid, offset, size, dst_mr, dst_off,
                                     _inline=True).wait()

    def _read_into_impl(self, oid: int, offset: int, size: int,
                        dst_mr: MemoryRegion, dst_off: int = 0) -> int:
        """Device-direct gather-read into the caller's registered region:
        over RDMA the engine scatters straight into it (ONE copy per byte,
        zero staging acquires); over TCP blocks stage through ring slots
        (per-slot locks, no engine-wide lock) and land with one SG splice
        per batch. This is the GPUDirect-RDMA analogue's transport leg
        (core.device_direct builds on it)."""
        if self.legacy:
            return self._read_into_legacy(oid, offset, size, dst_mr, dst_off)
        return self._gather_into(oid, offset, [(dst_mr, dst_off, size)])

    def _dst_rkey(self, mr: MemoryRegion) -> str:
        """Destination capability for server-initiated placement: the
        client grants a write-scoped rkey on ITS registered region (once
        per registration — persistent registrations like device-direct
        rings reuse the token across every read) and conveys it with the
        read request; the transport re-checks revocation/expiry/tenant on
        every placement, cached translation or not. A cached lease inside
        its expiry margin is renewed IN PLACE (same token — NIC caches
        stay valid), so long-lived sinks never hard-fault on TTL; a
        REVOKED key is never resurrected (renewal refused, the placement
        fails at the capability check as it must)."""
        ttl = self._dst_rkey_ttl
        with self._dst_rkey_lock:
            ent = self._dst_rkeys.get(mr.region_id)
            if ent is not None and ent[1] is mr:
                self._dst_rkeys.move_to_end(mr.region_id)
                token, _mr, expires_at = ent
                if time.monotonic() < expires_at - 0.25 * ttl:
                    return token
                try:
                    self.creg.renew(token, ttl)
                    self._dst_rkeys[mr.region_id] = \
                        (token, mr, time.monotonic() + ttl)
                except (AccessError, KeyError):
                    pass              # revoked/gone: hard-fails at use
                return token
        rk = self.creg.grant(mr, "w", ttl_s=ttl)
        dead = []
        with self._dst_rkey_lock:
            ent = self._dst_rkeys.get(mr.region_id)
            if ent is not None and ent[1] is mr:
                dead.append(rk.token)             # lost a concurrent grant
                token = ent[0]
            else:
                self._dst_rkeys[mr.region_id] = \
                    (rk.token, mr, time.monotonic() + ttl)
                token = rk.token
            # sweep entries whose region was deregistered behind our back
            # (the normal read()/readv_into()/sink-close paths retire via
            # drop_dst_rkey; this catches direct registry deregisters).
            # LIVE regions are never evicted — an entry per persistent
            # registration is exactly the bound we want, and evicting one
            # would retire a capability another thread is about to use.
            stale = [rid for rid, (tok, m, _e) in self._dst_rkeys.items()
                     if self.creg._regions.get(rid) is not m]
            for rid in stale:
                dead.append(self._dst_rkeys.pop(rid)[0])
        for tok in dead:
            self._retire_dst_token(tok)
        return token

    def _retire_dst_token(self, token: str) -> None:
        """Kill a placement capability for good: gone from the registry
        (not merely revoked — per-op grants must not grow the key table)
        and flushed from the NIC translation cache."""
        self.creg.retire(token)
        if hasattr(self.xport, "invalidate_rkey_cache"):
            self.xport.invalidate_rkey_cache(token)

    def drop_dst_rkey(self, mr: MemoryRegion) -> None:
        """Retire a destination region's placement capability (transient
        read buffers at deregister, sink teardown): the token dies with
        the registration, so a stale NIC cache entry can never land bytes
        in recycled memory — and neither the registry key table nor the
        translation cache accumulates one entry per pread()."""
        with self._dst_rkey_lock:
            ent = self._dst_rkeys.pop(mr.region_id, None)
        if ent is not None and ent[1] is mr:
            self._retire_dst_token(ent[0])

    def _fill_direct(self, obj, oid: int, b: int, bo: int, ln: int,
                     subs: Sequence) -> None:
        """Direct-splice fill of one block's destination sub-views (the
        hook point tests use to assert read concurrency, mirroring
        `_fetch_block` on the staged path). `subs` is [(view, lo, hi)] in
        block-relative coordinates. Decrypt is fused IN PLACE in the
        destination memory — one pass, zero staging."""
        with tracing.span("session.fetch"):
            obj.fetch_scatter(str(b), AKEY, bo, ln, subs)
        if self.crypto is not None:
            for view, lo, hi in subs:
                self.crypto.apply_into(view, view,
                                       nonce=oid * (1 << 20) + b,
                                       offset=bo + lo)

    def _gather_direct(self, oid: int, offset: int, dsts: Sequence) -> int:
        """ONE-copy gather: the engine scatters the extent overlay straight
        into the caller's registered destinations through the views the
        transport's `place_sg` validated — no staging-ring slot is ever
        acquired. One placement op (one capability check + one rendezvous)
        per destination region; descriptors mirror the (block, destination)
        overlaps exactly as the staged SG path's iovecs did."""
        spans, g = [], 0
        for mr, moff, sz in dsts:
            if sz > 0:
                spans.append((g, g + sz, mr, moff))
            g += sz
        size = g
        if size == 0:
            return 0
        obj = self.container.object(oid)
        blocks = split_blocks(offset, size)
        per_block = []      # (b, bo, ln, [(view_ref, lo_rel, hi_rel)])
        by_mr: "OrderedDict[int, tuple]" = OrderedDict()
        pos, si = 0, 0
        for b, bo, ln in blocks:
            subs = []
            while si < len(spans) and spans[si][1] <= pos:
                si += 1
            j = si
            while j < len(spans) and spans[j][0] < pos + ln:
                g0, g1, mr, moff = spans[j]
                lo, hi = max(pos, g0), min(pos + ln, g1)
                ent = by_mr.setdefault(id(mr), (mr, [], []))
                ent[1].append((moff + lo - g0, hi - lo))
                ref = [None]          # placed view lands here below
                ent[2].append(ref)
                subs.append((ref, lo - pos, hi - pos))
                j += 1
            per_block.append((b, bo, ln, subs))
            pos += ln
        with self._gauge_lock:
            self._active_reads += 1
            self.max_concurrent_reads = max(self.max_concurrent_reads,
                                            self._active_reads)
        try:
            for mr, descs, refs in by_mr.values():
                views = self._xport_op(lambda: self.xport.place_sg(
                    self._dst_rkey(mr), self.tenant, descs))
                for ref, view in zip(refs, views):
                    ref[0] = view
            for b, bo, ln, subs in per_block:
                self._fill_direct(obj, oid, b, bo, ln,
                                  [(ref[0], lo, hi) for ref, lo, hi in subs])
        finally:
            with self._gauge_lock:
                self._active_reads -= 1
        return size

    def _gather_into(self, oid: int, offset: int,
                     dsts: Sequence) -> int:
        """Shared gather core: direct splice when the transport supports
        server-initiated placement (RDMA zero-copy — the default), else
        fill destination spans [(mr, mr_off, size)] from the file range
        through the staging ring. A staged block may straddle destination
        boundaries: one SG descriptor per (block, destination) overlap,
        same as writev's source spans."""
        self._admit()
        if self.direct_reads:
            return self._gather_direct(oid, offset, dsts)
        # destination spans in gather-global byte coordinates (zero-size
        # destinations occupy no span and produce no descriptor)
        spans, g = [], 0
        for mr, moff, sz in dsts:
            if sz > 0:
                spans.append((g, g + sz, mr, moff))
            g += sz
        size = g
        if size == 0:
            return 0
        obj = self.container.object(oid)
        with self._gauge_lock:
            self._active_reads += 1
            self.max_concurrent_reads = max(self.max_concurrent_reads,
                                            self._active_reads)
        try:
            blocks = split_blocks(offset, size)
            pos = 0
            si = 0          # span cursor: spans and blocks both ascend
            for base in range(0, len(blocks), self.ring.n_slots):
                batch = blocks[base:base + self.ring.n_slots]
                slots = self.ring.acquire(len(batch))
                try:
                    iov = []
                    for (b, bo, ln), s in zip(batch, slots):
                        self._fetch_block(obj, oid, b, bo, ln,
                                          self.ring.view(s)[:ln])
                        while si < len(spans) and spans[si][1] <= pos:
                            si += 1
                        j = si
                        while j < len(spans) and spans[j][0] < pos + ln:
                            g0, g1, mr, moff = spans[j]
                            lo, hi = max(pos, g0), min(pos + ln, g1)
                            iov.append((self.ring.offset(s) + lo - pos,
                                        mr, moff + lo - g0, hi - lo))
                            j += 1
                        pos += ln
                    if self.transport_kind == "rdma":
                        self._maybe_expire_cap()
                        self._xport_op(lambda: self.xport.read_sg(
                            self._staging_token(), self.tenant, iov))
                    else:
                        self._xport_op(
                            lambda: self.xport.read_sg(self.staging, iov))
                finally:
                    self.ring.release(slots)
        finally:
            with self._gauge_lock:
                self._active_reads -= 1
        return size

    def read(self, oid: int, offset: int, size: int) -> bytes:
        """Blocking materializing read — submit + wait with inline
        execution (bit-identical; see `_read_impl`)."""
        return self.submit_read(oid, offset, size, _inline=True).wait()

    def _read_impl(self, oid: int, offset: int, size: int) -> bytes:
        if self.legacy:
            return self._read_legacy(oid, offset, size)
        dst = self.creg.register(np.empty(size, np.uint8), self.tenant)
        try:
            self._read_into_impl(oid, offset, size, dst, 0)
            return dst.buf.tobytes()
        finally:
            self.drop_dst_rkey(dst)       # per-op capability dies with MR
            self.creg.deregister(dst)

    # -- submit/reap surface (async completion-driven API) -------------------
    # Submitted op functions call the `_impl` bodies, NEVER the public
    # blocking wrappers: a wrapper re-submitting from inside a submitted op
    # would nest two SQ ring slots for one logical op and deadlock at
    # depth 1. The optional `_then` post-processing step is composed INTO
    # the op (see `_chain`). The `_inline` flag is how the blocking API is
    # expressed as submit + wait without a thread hop.

    def submit_writev(self, oid: int, offset: int, buffers: Sequence,
                      timeout: Optional[float] = None,
                      _inline: bool = False,
                      _then: Optional[Callable[[Any], Any]] = None
                      ) -> CompletionHandle:
        """Queue a vectored write; the handle's wait() yields the byte
        count."""
        return self._submit(
            "writev",
            _chain(lambda: self._writev_impl(oid, offset, buffers), _then),
            timeout=timeout, inline=_inline)

    def submit_readv_into(self, oid: int, offset: int, bufs: Sequence,
                          timeout: Optional[float] = None,
                          _inline: bool = False,
                          _then: Optional[Callable[[Any], Any]] = None
                          ) -> CompletionHandle:
        """Queue a vectored gather-read into caller buffers."""
        return self._submit(
            "readv_into",
            _chain(lambda: self._readv_into_impl(oid, offset, bufs), _then),
            timeout=timeout, inline=_inline)

    def submit_read_into(self, oid: int, offset: int, size: int,
                         dst_mr: MemoryRegion, dst_off: int = 0,
                         timeout: Optional[float] = None,
                         _inline: bool = False,
                         _then: Optional[Callable[[Any], Any]] = None
                         ) -> CompletionHandle:
        """Queue a device-direct read into a registered region."""
        return self._submit(
            "read_into",
            _chain(lambda: self._read_into_impl(oid, offset, size, dst_mr,
                                                dst_off), _then),
            timeout=timeout, inline=_inline)

    def submit_read(self, oid: int, offset: int, size: int,
                    timeout: Optional[float] = None,
                    _inline: bool = False,
                    _then: Optional[Callable[[Any], Any]] = None
                    ) -> CompletionHandle:
        """Queue a materializing read; the handle's wait() yields bytes."""
        return self._submit(
            "read",
            _chain(lambda: self._read_impl(oid, offset, size), _then),
            timeout=timeout, inline=_inline)

    def _sq_ring(self) -> Optional[_SubmissionRing]:
        return self.sq

    def close(self) -> None:
        """Drain in-flight completions and retire the dispatch pool."""
        self._close_submit()

    # -- EC cell plane (block-relative extent addressing) --------------------
    # Cells are MEDIA-domain bytes end to end: parity is linear over what
    # is on media (inline ciphertext included), so degraded reads and
    # rebuild reconstruct without tenant keys and no crypto is applied on
    # this plane. Parity cells live at block-relative offsets >= BLOCK —
    # virtual addresses the file-offset API can never reach.

    def update_cell(self, oid: int, block: int, cell_off: int,
                    payload) -> None:
        """Write one EC cell: same admission, staging-ring, transport-SG
        and donation discipline as `writev`, addressed to (block,
        cell_off) directly."""
        self._admit()
        arr = payload if isinstance(payload, np.ndarray) \
            else np.frombuffer(bytes(payload), np.uint8)
        ln = int(arr.size)
        if ln == 0:
            return
        obj = self.container.object(oid)
        mr = self.creg.register(np.ascontiguousarray(arr), self.tenant)
        epoch = self.container.next_epoch()
        try:
            slots = self.ring.acquire(1)
            try:
                s = slots[0]
                iov = [(self.ring.offset(s), mr, 0, ln)]
                if self.transport_kind == "rdma":
                    self._maybe_expire_cap()
                    self._xport_op(lambda: self.xport.write_sg(
                        self._staging_token(), self.tenant, iov))
                else:
                    self._xport_op(
                        lambda: self.xport.write_sg(self.staging, iov))
                view = self.ring.view(s)[:ln]
                if self.zero_copy:
                    obj.update_many([(str(block), AKEY, cell_off, view)],
                                    epoch=epoch,
                                    leases=[self.ring.donate(s)])
                else:
                    obj.update_many(
                        [(str(block), AKEY, cell_off, view.tobytes())],
                        epoch=epoch, leases=[None])
                    with self._gauge_lock:
                        self.host_copy_bytes += ln
            finally:
                self.ring.release(slots)
        finally:
            self.creg.deregister(mr)

    def xor_apply(self, oid: int, block: int, cell_off: int,
                  delta) -> None:
        """Ship one parity DELTA and apply it target-side — the delta-
        parity RMW wire op. Same admission, staging-ring and transport-SG
        discipline as `update_cell`, but the payload is a GF(256) parity
        delta (`C[:, touched] x (old XOR new)` rows), not a cell image:
        the engine's `DAOSObject.xor_apply` reads the stored base under
        its RMW lock and commits base XOR delta in one epoch, so a
        partial-stripe write costs ONE delta transfer per parity target
        instead of a full-stripe read + re-encoded parity writes. No slot
        donation — the staged delta is consumed inside the engine call
        (the committed extent is the XOR result, not the staged bytes)."""
        self._admit()
        arr = delta if isinstance(delta, np.ndarray) \
            else np.frombuffer(bytes(delta), np.uint8)
        ln = int(arr.size)
        if ln == 0:
            return
        obj = self.container.object(oid)
        mr = self.creg.register(np.ascontiguousarray(arr), self.tenant)
        epoch = self.container.next_epoch()
        try:
            slots = self.ring.acquire(1)
            try:
                s = slots[0]
                iov = [(self.ring.offset(s), mr, 0, ln)]
                if self.transport_kind == "rdma":
                    self._maybe_expire_cap()
                    self._xport_op(lambda: self.xport.write_sg(
                        self._staging_token(), self.tenant, iov))
                else:
                    self._xport_op(
                        lambda: self.xport.write_sg(self.staging, iov))
                obj.xor_apply(str(block), AKEY, cell_off,
                              self.ring.view(s)[:ln], epoch=epoch)
                with self._gauge_lock:
                    self.host_copy_bytes += ln
            finally:
                self.ring.release(slots)
        finally:
            self.creg.deregister(mr)

    def fetch_cell(self, oid: int, block: int, cell_off: int,
                   ln: int) -> np.ndarray:
        """Read one EC cell's raw media bytes through the staged transport
        path. Holes read as zeros — the zero-pad convention parity is
        computed under, so sparse stripes decode bit-exactly."""
        self._admit()
        obj = self.container.object(oid)
        out = np.empty(ln, np.uint8)
        mr = self.creg.register(out, self.tenant)
        try:
            slots = self.ring.acquire(1)
            try:
                s = slots[0]
                obj.fetch_into(str(block), AKEY, cell_off, ln,
                               self.ring.view(s)[:ln])
                with self._gauge_lock:
                    self.bounce_bytes += ln
                iov = [(self.ring.offset(s), mr, 0, ln)]
                if self.transport_kind == "rdma":
                    self._maybe_expire_cap()
                    self._xport_op(lambda: self.xport.read_sg(
                        self._staging_token(), self.tenant, iov))
                else:
                    self._xport_op(
                        lambda: self.xport.read_sg(self.staging, iov))
            finally:
                self.ring.release(slots)
        finally:
            self.creg.deregister(mr)
        return out

    def read_markers(self, oid: int, block: int, n_cells: int) -> bytes:
        """This target's dirty-cell ledger byte-map for one stripe (zeros
        = clean). Engine-direct: the ledger is repair metadata, a few
        bytes per stripe, not data-plane payload."""
        self._admit()
        obj = self.container.peek_object(oid)
        if obj is None:
            return b"\x00" * n_cells
        return obj.fetch(str(block), EC_DIRTY_AKEY, 0, n_cells)

    def mark_cells(self, oid: int, block: int,
                   cells: Sequence[int]) -> None:
        """Record dropped cell writes in this target's ledger — one byte
        per cell index, one epoch. Rebuild regenerates exactly the marked
        cells and clears the marks."""
        self._admit()
        obj = self.container.object(oid)
        obj.update_many([(str(block), EC_DIRTY_AKEY, int(i), b"\x01")
                         for i in cells])

    def clear_cells(self, oid: int, block: int, cells: Sequence[int],
                    n_cells: int) -> None:
        """Retire dirty markers after a heal-on-write rewrote the cells at
        the current version; an all-clean ledger extent is punched so
        repaired stripes leave zero metadata behind. Only touches ledgers
        that exist — clearing never CREATES ledger state."""
        self._admit()
        obj = self.container.peek_object(oid)
        dk = str(block)
        if obj is None or dk not in obj.dkeys(EC_DIRTY_AKEY):
            return
        obj.update_many([(dk, EC_DIRTY_AKEY, int(i), b"\x00")
                         for i in cells])
        if not any(obj.fetch(dk, EC_DIRTY_AKEY, 0, n_cells)):
            obj.punch(dk, EC_DIRTY_AKEY)

    # -- seed per-block path (kept verbatim for `legacy=True` benchmarks) ----
    def _write_legacy(self, oid: int, offset: int, data) -> None:
        arr = np.frombuffer(bytes(data), np.uint8) if not isinstance(
            data, np.ndarray) else data
        obj = self.container.object(oid)
        with self._lock:
            pos = 0
            for b, bo, ln in split_blocks(offset, arr.size):
                chunk = arr[pos:pos + ln]
                if self.crypto is not None:
                    chunk = self.crypto.apply(chunk, nonce=oid * (1 << 20) + b,
                                              offset=bo)
                src = self.creg.register(np.ascontiguousarray(chunk),
                                         self.tenant)
                try:
                    if self.transport_kind == "rdma":
                        self.xport.write(self._staging_token(), self.tenant, 0,
                                         src, 0, ln)
                    else:
                        self.xport.write(self.staging, 0, src, 0, ln)
                    obj.update(str(b), AKEY, bo,
                               self.staging.buf[:ln].tobytes())
                finally:
                    self.creg.deregister(src)
                pos += ln

    def _read_into_legacy(self, oid: int, offset: int, size: int,
                          dst_mr: MemoryRegion, dst_off: int = 0) -> int:
        obj = self.container.object(oid)
        with self._lock:
            pos = 0
            for b, bo, ln in split_blocks(offset, size):
                data = obj.fetch(str(b), AKEY, bo, ln)
                self.staging.buf[:ln] = np.frombuffer(data, np.uint8)
                if self.crypto is not None:
                    self.staging.buf[:ln] = self.crypto.apply(
                        self.staging.buf[:ln], nonce=oid * (1 << 20) + b,
                        offset=bo)
                if self.transport_kind == "rdma":
                    self.xport.read(self._staging_token(), self.tenant, 0,
                                    dst_mr, dst_off + pos, ln)
                else:
                    self.xport.read(self.staging, 0, dst_mr,
                                    dst_off + pos, ln)
                pos += ln
        return size

    def _read_legacy(self, oid: int, offset: int, size: int) -> bytes:
        obj = self.container.object(oid)
        out = np.zeros(size, np.uint8)
        with self._lock:
            pos = 0
            for b, bo, ln in split_blocks(offset, size):
                data = obj.fetch(str(b), AKEY, bo, ln)
                self.staging.buf[:ln] = np.frombuffer(data, np.uint8)
                dst = self.creg.register(ln, self.tenant)
                try:
                    if self.transport_kind == "rdma":
                        self.xport.read(self._staging_token(), self.tenant, 0,
                                        dst, 0, ln)
                    else:
                        self.xport.read(self.staging, 0, dst, 0, ln)
                    chunk = dst.buf[:ln]
                    if self.crypto is not None:
                        chunk = self.crypto.apply(chunk,
                                                  nonce=oid * (1 << 20) + b,
                                                  offset=bo)
                    out[pos:pos + ln] = chunk
                finally:
                    self.creg.deregister(dst)
                pos += ln
        return out.tobytes()


class _EcDeltaUnavailable(Exception):
    """The delta-parity RMW path lost a prerequisite BEFORE dispatch (an
    old-bytes fetch failed persistently): internal signal to fall back to
    the full re-encode path, counted as `ec.delta_fallbacks`. Never
    escapes the router — once deltas dispatch, failures are per-cell
    dirty-marker events exactly like the full path's."""


class _ClusterRouter(_SubmitReap):
    """Thin client-side router over per-target data-plane sessions.

    The monolithic `_ServerIO` of the single-server stack is now the PER-
    TARGET session; this router is everything cluster-shaped on the client:

      * placement — the same jump-consistent `placement_order` the server
        uses, evaluated per 1 MiB block with ZERO per-op metadata lookups;
        consecutive same-target blocks coalesce into one session call, so
        a striped `readv_into`/`writev` costs one SG/placement op per
        contiguous per-target run.
      * parallel striping — runs for different targets execute
        concurrently (one pool task per target), which is where the
        1→N-target sequential-bandwidth scaling comes from.
      * map lease discipline — the router holds a VERSIONED map snapshot;
        a server push (or a TargetDownError from a session whose target
        went down under a stale map) marks it stale, and the next op pays
        exactly ONE `get_pool_map` refresh then re-routes. Target ADD is
        discovered the same way; sessions for new targets are built
        lazily via the owner's factory.
      * fleet counters — `data_path_counters()` merges every session's
        transport/engine/media/staging/client counters with the cluster-
        level stats (cross-target heals, fleet scrubs) via
        `merge_counters`, plus a `cluster` section (map version/refreshes/
        retries).

    The API up (write/writev/read/read_into/readv_into/drop_dst_rkey/
    data_path_counters) is exactly `_ServerIO`'s, so DFS, device-direct
    sinks and the DPU runtime ride it unchanged."""

    def __init__(self, sessions: Dict[int, _ServerIO], control: ControlPlane,
                 client_registry: MemoryRegistry, tenant: str,
                 make_session: Callable[[int], _ServerIO],
                 cluster_stats: Callable[[], Any],
                 zero_copy: bool = True,
                 faults: Optional[FaultInjector] = None,
                 timeouts: Timeouts = DEFAULT_TIMEOUTS,
                 redundancy_key: Optional[str] = None,
                 crypto: Optional[InlineCrypto] = None,
                 io_depth: int = 16, device: DeviceLike = None):
        self.sessions = sessions
        # where the EC parity kernel runs (encode, delta, degraded read)
        self.device = resolve_device(device)
        self.cp = control
        self.creg = client_registry
        self.tenant = tenant
        self._make_session = make_session
        self._cluster_stats = cluster_stats
        self.zero_copy = zero_copy
        self._faults = faults
        self.timeouts = timeouts
        # erasure-coded redundancy class, learned from the pool map (the
        # "pool/container" key this client mounted): (k, p, cell_bytes)
        # when the container is EC, else None and every path below is the
        # replicated fast path unchanged
        self._redundancy_key = redundancy_key
        self._ec: Optional[Tuple[int, int, int]] = None
        self._crypto = crypto
        self.ec_degraded_reads = 0    # blocks served via reconstruction
        self.ec_reconstructions = 0   # cells decoded from survivors
        self.ec_delta_writes = 0      # partial-stripe writes that took the
        # delta-parity RMW path (old-bytes fetch + p xor_apply deltas)
        self.ec_delta_bytes_saved = 0  # stripe-read bytes the delta path
        # did NOT fetch vs the full k-cell re-encode read
        self.ec_delta_fallbacks = 0   # partial writes degraded to a full
        # re-encode (touched/parity target down, or old-bytes fetch lost
        # its target mid-op)
        self._ec_pending: List = []   # straggler cell writes in flight
        self._sid: Optional[int] = None
        self.cache = None
        self._map_lock = threading.Lock()
        self._map_version = 0
        self._tids: List[int] = []
        self._up: Dict[int, bool] = {}
        self._domains: Optional[Tuple[Optional[str], ...]] = None
        self._map_stale = True
        self.map_refreshes = 0        # get_pool_map RPCs paid
        self.map_invalidations = 0    # server pushes received
        self.target_retries = 0       # retry ROUNDS after a refresh
        self.retried_runs = 0         # per-target runs re-dispatched —
        # surgical: only the FAILED target's fragments, never the whole op
        # (oid, dkey) -> tuple of target ids in placement order, valid for
        # the ADOPTED map only (_adopt clears it): striped ops recompute
        # the jump-hash projection per block per op otherwise
        self._place_cache: "OrderedDict[Tuple[int, str], Tuple[int, ...]]" \
            = OrderedDict()
        self.placement_cache_hits = 0
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        # submit/reap state: ONE shared CQ for the whole client plus one
        # submission ring per target so io_depth bounds in-flight per
        # target (a coalesced per-target run takes ONE slot — fragments
        # inside it still ride a single SG/placement verb)
        self._init_submit(io_depth, timeouts)
        self._rings: Dict[int, _SubmissionRing] = {}
        self._rings_lock = threading.Lock()

    def _target_ring(self, tid: int) -> _SubmissionRing:
        with self._rings_lock:
            ring = self._rings.get(tid)
            if ring is None:
                ring = _SubmissionRing(self.io_depth, self.timeouts)
                self._rings[tid] = ring
            return ring

    # -- session / map lifecycle ---------------------------------------------
    def attach_session(self, session_id: int,
                       rkeys: Optional[Dict[int, str]] = None,
                       rkey_ttl_s: Optional[float] = None,
                       cache=None, pool_map: Optional[Dict] = None) -> None:
        """Adopt the compound bring-up's results: the control session, one
        staging rkey per target, and the pool-map snapshot fetched in the
        SAME round-trip. Subscribes to map pushes (lease recalls)."""
        self._sid = session_id
        self.cache = cache
        rkeys = rkeys or {}
        for tid, sess in self.sessions.items():
            sess.attach_session(session_id, rkeys.get(tid), rkey_ttl_s,
                                cache)
        if pool_map is not None:
            self._adopt(pool_map)
        self.cp.subscribe_map(session_id, self._on_map_push)

    def _on_map_push(self, version: int) -> None:
        with self._map_lock:
            self._map_stale = True
            self.map_invalidations += 1

    def _adopt(self, m: Dict) -> None:
        red = m.get("redundancy", {}).get(self._redundancy_key or "", {})
        ec = red.get("ec") if isinstance(red, dict) else None
        with self._map_lock:
            self._map_version = m["version"]
            self._place_cache.clear()   # placement keys off the map shape
            self._up = {t["target_id"]: t["up"] for t in m["targets"]}
            self._tids = sorted(self._up)
            by_tid = {t["target_id"]: t.get("domain") for t in m["targets"]}
            doms = tuple(by_tid.get(tid) for tid in self._tids)
            self._domains = None if all(d is None for d in doms) else doms
            if ec:
                self._ec = (int(ec["k"]), int(ec["p"]),
                            int(ec["cell_bytes"]))
            self._map_stale = False
            missing = [tid for tid in self._tids
                       if tid not in self.sessions]
        for tid in missing:           # target ADD: session built lazily
            self.sessions[tid] = self._make_session(tid)

    def _refresh_map(self) -> None:
        # a refresh that fails on a dropped/errored RPC gets ONE retry —
        # the map is the recovery path, so it must survive transient
        # control-plane faults itself
        r = self.cp.rpc("get_pool_map", session_id=self._sid)
        if not r["ok"]:
            r = self.cp.rpc("get_pool_map", session_id=self._sid)
            if not r["ok"]:
                raise StorageError(f"pool map refresh failed: {r['error']}")
            note_recovery(self._faults, "control.rpc_retry")
        self._adopt(r)
        with self._map_lock:
            self.map_refreshes += 1

    def _ensure_map(self) -> None:
        with self._map_lock:
            stale = self._map_stale or not self._tids
        if stale:                     # a stale map is ONE refresh, ever
            self._refresh_map()

    _PLACE_CACHE_CAP = 4096           # ~64 open files x 64 blocks resident

    def _placement(self, oid: int, dkey: str) -> Tuple[int, ...]:
        """Target ids in the block's deterministic placement order,
        memoized per (oid, dkey) against the ADOPTED map. placement_order
        is a jump-hash + domain-spread walk recomputed per BLOCK on every
        striped op today; this LRU turns the hot re-visit into one dict
        hit (`cluster.placement_cache_hits`). Keyed off the map implicitly:
        `_adopt` clears the cache whenever a new map version lands, so a
        cached order can never outlive the membership/domain layout it was
        computed from (up/down flips do NOT reshuffle placement — liveness
        is applied by the callers on top of the cached order)."""
        key = (oid, dkey)
        with self._map_lock:
            hit = self._place_cache.get(key)
            if hit is not None:
                self._place_cache.move_to_end(key)
                self.placement_cache_hits += 1
                return hit
            tids, doms = list(self._tids), self._domains
        order = tuple(tids[i] for i in
                      placement_order(len(tids), oid, dkey, doms))
        with self._map_lock:
            # cache only against the map we computed from (racing _adopt)
            if tids == self._tids and doms == self._domains:
                self._place_cache[key] = order
                while len(self._place_cache) > self._PLACE_CACHE_CAP:
                    self._place_cache.popitem(last=False)
        return order

    def _route_block(self, oid: int, b: int) -> int:
        """First UP target in the block's deterministic placement order
        (domain-aware when the pool map labels fault domains: failover
        prefers a target in a DIFFERENT domain than the primary's)."""
        with self._map_lock:
            up = dict(self._up)
        for tid in self._placement(oid, str(b)):
            if up.get(tid):
                return tid
        raise StorageError("no live targets in pool map")

    # -- striped dispatch core -----------------------------------------------
    def _get_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="cluster-router")
            return self._pool

    @staticmethod
    def _merge_runs(items: List[Tuple[int, int, list]]) -> List[Tuple[int,
                                                                      list]]:
        """Coalesce file-contiguous fragments (already in ascending file
        order) into single session calls: one SG/placement op per run."""
        runs: List[List] = []
        for fo, ln, payload in items:
            if runs and runs[-1][0] + runs[-1][1] == fo:
                runs[-1][1] += ln
                runs[-1][2].extend(payload)
            else:
                runs.append([fo, ln, list(payload)])
        return [(fo, payload) for fo, _ln, payload in runs]

    def _dispatch(self, oid: int, frags: List[Tuple[int, int, int, list]],
                  call) -> None:
        """Route block fragments [(block, file_off, len, payload)] to their
        targets and execute per-target batches — in parallel when the op
        stripes across more than one target.

        Failure hardening (surgical retries): a per-target batch failing
        with TargetDownError (stale map hit a dead target, or the target
        crashed mid-op) costs one map refresh and a re-dispatch of ONLY
        that target's fragments — batches that already succeeded are never
        re-executed (`retried_runs` counts exactly the re-dispatched
        runs). Retries are bounded by `timeouts.retry_budget` with capped
        exponential backoff (the first retry is free — the stale-map trip
        stays a single cheap re-route) and the whole op by
        `timeouts.op_deadline_s`. Any non-TargetDown error propagates
        immediately — only routable failures are retried."""
        self._ensure_map()
        start = time.monotonic()
        pending = list(frags)
        attempt = 0
        while True:
            groups: Dict[int, List[Tuple[int, int, int, list]]] = {}
            for frag in pending:
                groups.setdefault(self._route_block(oid, frag[0]),
                                  []).append(frag)
            batches = {tid: self._merge_runs(
                           [(fo, ln, payload)
                            for _b, fo, ln, payload in items])
                       for tid, items in groups.items()}
            failed: Dict[int, TargetDownError] = {}
            if len(batches) == 1:
                (tid, runs), = batches.items()
                try:
                    self._run_batch(tid, oid, runs, call)
                except TargetDownError as e:
                    failed[tid] = e
            else:
                pool = self._get_pool()
                futs = {tid: pool.submit(self._run_batch, tid, oid, runs,
                                         call)
                        for tid, runs in batches.items()}
                other = None
                for tid, fut in futs.items():
                    e = fut.exception()
                    if isinstance(e, TargetDownError):
                        failed[tid] = e
                    elif e is not None and other is None:
                        other = e
                if other is not None:
                    raise other
            if not failed:
                if attempt:
                    note_recovery(self._faults, "dispatch.retry")
                return
            attempt += 1
            err = next(iter(failed.values()))
            elapsed = time.monotonic() - start
            if attempt > self.timeouts.retry_budget:
                raise err
            if elapsed > self.timeouts.op_deadline_s:
                raise OpTimeout(
                    "cluster.dispatch",
                    target=",".join(f"t{t}" for t in sorted(failed)),
                    elapsed_s=elapsed,
                    detail=f"retry {attempt} of "
                           f"{self.timeouts.retry_budget}: {err}")
            self._refresh_map()
            with self._map_lock:
                self.target_retries += 1
                self.retried_runs += sum(len(batches[tid])
                                         for tid in failed)
            time.sleep(self.timeouts.backoff(
                attempt, salt=min(failed) if failed else 0))
            # surgical: ONLY the failed targets' fragments go back in
            # (re-sorted to ascending file order — _merge_runs coalesces
            # contiguous runs under that invariant)
            pending = sorted((frag for tid, items in groups.items()
                              if tid in failed for frag in items),
                             key=lambda f: f[1])

    def _run_batch(self, tid: int, oid: int, runs, call) -> None:
        # one per-target SQ slot per coalesced batch: io_depth batches of
        # one target may execute at once, whether they come from the async
        # submit surface or the striping pool's concurrent per-target tasks
        ring = self._target_ring(tid)
        ring.acquire()
        try:
            sess = self.sessions[tid]
            for fo, payload in runs:
                call(sess, oid, fo, payload)
        finally:
            ring.release()

    # -- vectored write path -------------------------------------------------
    def write(self, oid: int, offset: int, data) -> None:
        self.writev(oid, offset, [data])

    def writev(self, oid: int, offset: int, buffers: Sequence) -> int:
        """Blocking striped write — submit + wait with inline execution
        (bit-identical; see `_writev_impl`)."""
        return self.submit_writev(oid, offset, buffers, _inline=True).wait()

    def _writev_impl(self, oid: int, offset: int,
                     buffers: Sequence) -> int:
        """Striped scatter-gather write: each 1 MiB block routes to its
        placement target; per-target runs commit through that target's own
        session (ring, transport, epoch) concurrently. EC containers take
        the striped-parity fan-out instead."""
        self._ensure_map()
        if self._ec is not None:
            return self._ec_writev(oid, offset, buffers)
        arrs = [a if isinstance(a, np.ndarray)
                else np.frombuffer(bytes(a), np.uint8) for a in buffers]
        arrs = [a for a in arrs if a.size]
        total = int(sum(a.size for a in arrs))
        if total == 0:
            return 0
        spans, g = [], 0
        for a in arrs:
            spans.append((g, g + a.size, a))
            g += a.size
        frags, pos, si = [], 0, 0
        for b, bo, ln in split_blocks(offset, total):
            parts = []
            while si < len(spans) and spans[si][1] <= pos:
                si += 1
            j = si
            while j < len(spans) and spans[j][0] < pos + ln:
                g0, _g1, a = spans[j]
                lo, hi = max(pos, spans[j][0]), min(pos + ln, spans[j][1])
                parts.append(a[lo - g0:hi - g0])
                j += 1
            frags.append((b, b * BLOCK + bo, ln, parts))
            pos += ln
        self._dispatch(oid, frags,
                       lambda s, o, fo, bufs: s.writev(o, fo, bufs))
        return total

    # -- vectored read path --------------------------------------------------
    @property
    def supports_readv_into(self) -> bool:
        return self.zero_copy

    def _gather_into(self, oid: int, offset: int, dsts: Sequence) -> int:
        self._ensure_map()
        if self._ec is not None:
            with tracing.span("ec.gather"):
                return self._ec_gather_into(oid, offset, dsts)
        spans, g = [], 0
        for mr, moff, sz in dsts:
            if sz > 0:
                spans.append((g, g + sz, mr, moff))
            g += sz
        size = g
        if size == 0:
            return 0
        frags, pos, si = [], 0, 0
        for b, bo, ln in split_blocks(offset, size):
            subs = []
            while si < len(spans) and spans[si][1] <= pos:
                si += 1
            j = si
            while j < len(spans) and spans[j][0] < pos + ln:
                g0, _g1, mr, moff = spans[j]
                lo, hi = max(pos, spans[j][0]), min(pos + ln, spans[j][1])
                subs.append((mr, moff + lo - g0, hi - lo))
                j += 1
            frags.append((b, b * BLOCK + bo, ln, subs))
            pos += ln
        self._dispatch(oid, frags,
                       lambda s, o, fo, d: s._gather_into(o, fo, d))
        return size

    def read_into(self, oid: int, offset: int, size: int,
                  dst_mr: MemoryRegion, dst_off: int = 0) -> int:
        return self.submit_read_into(oid, offset, size, dst_mr, dst_off,
                                     _inline=True).wait()

    def _read_into_impl(self, oid: int, offset: int, size: int,
                        dst_mr: MemoryRegion, dst_off: int = 0) -> int:
        return self._gather_into(oid, offset, [(dst_mr, dst_off, size)])

    def readv_into(self, oid: int, offset: int, bufs: Sequence) -> int:
        return self.submit_readv_into(oid, offset, bufs,
                                      _inline=True).wait()

    def _readv_into_impl(self, oid: int, offset: int,
                         bufs: Sequence) -> int:
        mrs = [self.creg.register(b, self.tenant) for b in bufs]
        try:
            return self._gather_into(
                oid, offset, [(mr, 0, mr.size) for mr in mrs])
        finally:
            for mr in mrs:
                self.drop_dst_rkey(mr)
                self.creg.deregister(mr)

    def read(self, oid: int, offset: int, size: int) -> bytes:
        return self.submit_read(oid, offset, size, _inline=True).wait()

    def _read_impl(self, oid: int, offset: int, size: int) -> bytes:
        dst = self.creg.register(np.empty(size, np.uint8), self.tenant)
        try:
            self._read_into_impl(oid, offset, size, dst, 0)
            return dst.buf.tobytes()
        finally:
            self.drop_dst_rkey(dst)
            self.creg.deregister(dst)

    # -- submit/reap surface --------------------------------------------------
    # Same contract as _ServerIO's: op functions call the `_impl` bodies;
    # depth is bounded PER TARGET inside `_run_batch` (no router-global
    # ring), so a deep queue against one target never starves another.

    def submit_writev(self, oid: int, offset: int, buffers: Sequence,
                      timeout: Optional[float] = None,
                      _inline: bool = False,
                      _then: Optional[Callable[[Any], Any]] = None
                      ) -> CompletionHandle:
        """Queue a striped vectored write; wait() yields the byte count."""
        return self._submit(
            "writev",
            _chain(lambda: self._writev_impl(oid, offset, buffers), _then),
            timeout=timeout, inline=_inline)

    def submit_readv_into(self, oid: int, offset: int, bufs: Sequence,
                          timeout: Optional[float] = None,
                          _inline: bool = False,
                          _then: Optional[Callable[[Any], Any]] = None
                          ) -> CompletionHandle:
        """Queue a striped gather-read into caller buffers."""
        return self._submit(
            "readv_into",
            _chain(lambda: self._readv_into_impl(oid, offset, bufs), _then),
            timeout=timeout, inline=_inline)

    def submit_read_into(self, oid: int, offset: int, size: int,
                         dst_mr: MemoryRegion, dst_off: int = 0,
                         timeout: Optional[float] = None,
                         _inline: bool = False,
                         _then: Optional[Callable[[Any], Any]] = None
                         ) -> CompletionHandle:
        """Queue a striped read into a registered region."""
        return self._submit(
            "read_into",
            _chain(lambda: self._read_into_impl(oid, offset, size, dst_mr,
                                                dst_off), _then),
            timeout=timeout, inline=_inline)

    def submit_read(self, oid: int, offset: int, size: int,
                    timeout: Optional[float] = None,
                    _inline: bool = False,
                    _then: Optional[Callable[[Any], Any]] = None
                    ) -> CompletionHandle:
        """Queue a striped materializing read; wait() yields bytes."""
        return self._submit(
            "read",
            _chain(lambda: self._read_impl(oid, offset, size), _then),
            timeout=timeout, inline=_inline)

    def drop_dst_rkey(self, mr: MemoryRegion) -> None:
        """Retire the destination capability on EVERY target session (each
        grants its own placement rkey on the shared client region)."""
        for sess in list(self.sessions.values()):
            sess.drop_dst_rkey(mr)

    # -- erasure-coded data path ---------------------------------------------
    # ec(k,p) stripes each block as k data + p parity cells over k+p
    # DISTINCT targets in placement order. Cells are MEDIA-domain bytes
    # (parity is linear over the on-media image, ciphertext included), so
    # data cells ride the unchanged per-target session write/read path at
    # their natural file offsets while parity and reconstruction traffic
    # use the raw cell plane. A cell whose target is down is DROPPED (no
    # failover — its identity is its placement slot) and recorded in the
    # fleet's dirty-cell ledger; the write acks at k+1 landed cells with
    # the rest finishing in background, and reads reconstruct missing
    # cells from any k clean survivors.

    def _ec_order(self, oid: int, b: int) -> List[int]:
        with self._map_lock:
            k, p, _cs = self._ec
        order = list(self._placement(oid, str(b)))
        if len(order) < k + p:
            raise StorageError(
                f"ec({k},{p}) needs {k + p} targets, pool map has "
                f"{len(order)}")
        return order

    def _ec_media_image(self, arr: np.ndarray, oid: int, b: int,
                        bo: int) -> np.ndarray:
        """The media-domain bytes a fragment will occupy on its data
        cells: the session applies the same deterministic keystream at
        commit, so parity computed here matches what lands."""
        if self._crypto is None:
            return arr
        out = np.asarray(self._crypto.apply(arr, nonce=oid * (1 << 20) + b,
                                            offset=bo), np.uint8)
        return out

    def _ec_reap(self) -> None:
        """Drop completed straggler futures (errors were handled inside
        the job); called on op entry so the pending list stays bounded."""
        with self._map_lock:
            self._ec_pending = [f for f in self._ec_pending if not f.done()]

    def _ec_drain(self) -> None:
        """Join every in-flight straggler cell write (counters snapshots
        and close() want a quiesced stripe state)."""
        with self._map_lock:
            pend, self._ec_pending = self._ec_pending, []
        for f in pend:
            f.result()

    def _ec_mark_dirty(self, oid: int, b: int,
                       cells: Sequence[int]) -> None:
        """Record dropped cells in the dirty ledger of every UP target (a
        union survives any single ledger holder dying); at least one copy
        must land or the write cannot safely ack."""
        with self._map_lock:
            tids = [t for t in self._tids if self._up.get(t)]
        landed = 0
        for tid in tids:
            try:
                self.sessions[tid].mark_cells(oid, b, cells)
                landed += 1
            except StorageError:
                continue
        if not landed:
            raise StorageError(
                f"ec dirty marker for cells {list(cells)} of block {b} "
                "could not be recorded on any target")

    def _ec_retry(self, fn):
        """One bounded retransmit for a transient cell-plane failure. The
        engine aborts a failed commit/read atomically (no torn extent), so
        an immediate retry is safe — and a transient media/wire anomaly
        usually clears, sparing a dirty marker or a survivor exclusion.
        TargetDownError propagates untried: a down target stays down until
        the pool map says otherwise."""
        try:
            return fn()
        except TargetDownError:
            raise
        except StorageError:
            out = fn()
            note_recovery(self._faults, "ec.cell_retry")
            return out

    def _ec_read_dirty(self, oid: int, b: int) -> set:
        """The fleet-union dirty-cell set for one stripe (unreachable
        ledger holders tolerated — their stale copy only re-triggers an
        idempotent rebuild later)."""
        k, p, _cs = self._ec
        with self._map_lock:
            tids = [t for t in self._tids if self._up.get(t)]
        out: set = set()
        for tid in tids:
            try:
                marks = self.sessions[tid].read_markers(oid, b, k + p)
            except StorageError:
                continue
            out |= {i for i, byte in enumerate(marks) if byte}
        return out

    def _ec_clear_dirty(self, oid: int, b: int,
                        cells: Sequence[int]) -> None:
        if not cells:
            return
        k, p, _cs = self._ec
        with self._map_lock:
            tids = [t for t in self._tids if self._up.get(t)]
        for tid in tids:
            try:
                self.sessions[tid].clear_cells(oid, b, cells, k + p)
            except StorageError:
                continue

    def _ec_writev(self, oid: int, offset: int, buffers: Sequence) -> int:
        from repro_torch.kernels.rs_parity import ops as rs
        self._ec_reap()
        arrs = [a if isinstance(a, np.ndarray)
                else np.frombuffer(bytes(a), np.uint8) for a in buffers]
        arrs = [a for a in arrs if a.size]
        total = int(sum(a.size for a in arrs))
        if total == 0:
            return 0
        data = arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
        pos = 0
        for b, bo, ln in split_blocks(offset, total):
            self._ec_write_block(rs, oid, b, bo, data[pos:pos + ln])
            pos += ln
        return total

    def _ec_write_block(self, rs, oid: int, b: int, bo: int,
                        frag: np.ndarray) -> None:
        """One stripe's write: parity over the zero-padded full block in
        the media domain (partial writes read-modify-write the stripe
        image first), then a parallel fan-out of the touched data cells
        (full session writev path — staging, transport, inline crypto)
        and the p parity cells (raw cell plane). Foreground returns once
        min(jobs, k+1) cells land; stragglers finish in background.
        Cells on down targets are dropped and marked dirty — more than p
        of them and the stripe would go below k clean cells, which is a
        hard error BEFORE any byte moves.

        HEAL-ON-WRITE: a stripe that already carries dirty cells has no
        silent failure margin left — losing one more cell in a later
        write would tear it below k clean cells even though each write
        individually stayed within p. So a write to a pre-dirty stripe
        goes SYNCHRONOUS and also rewrites every reachable stale cell at
        the new version (the RMW image reconstructs their true content),
        clearing the ledger for everything that lands. After any write,
        the dirty set is exactly {cells on down targets} ∪ {cells that
        failed THIS write} — bounded by the pre-checks below.

        DELTA-PARITY RMW: a partial write to a CLEAN stripe whose touched
        data + parity targets are all up takes `_ec_write_block_delta`
        instead — it never reads the untouched k-|touched| cells. This
        full path survives as the stripe-covering write, the heal-on-write
        path, and the counted fallback when the delta path's
        prerequisites fail (`ec.delta_fallbacks`)."""
        k, p, cs = self._ec
        ln = int(frag.size)
        order = self._ec_order(oid, b)
        pre_dirty = {c for c in self._ec_read_dirty(oid, b) if c < k + p}
        partial = not (bo == 0 and ln == BLOCK)
        dtouch = sorted(set(range(bo // cs, (bo + ln - 1) // cs + 1)))
        if partial and not pre_dirty and len(dtouch) < k:
            with self._map_lock:
                up = dict(self._up)
            if all(up.get(order[c])
                   for c in dtouch + list(range(k, k + p))):
                try:
                    self._ec_write_block_delta(rs, oid, b, bo, frag,
                                               order, dtouch)
                    return
                except _EcDeltaUnavailable:
                    pass          # prerequisites lost mid-op: re-encode
            with self._map_lock:
                self.ec_delta_fallbacks += 1
            note_recovery(self._faults, "ec.delta_fallback")
        if bo == 0 and ln == BLOCK:
            media = self._ec_media_image(np.ascontiguousarray(frag),
                                         oid, b, 0)
        else:
            media = self._ec_read_media_block(rs, oid, b)
            media[bo:bo + ln] = self._ec_media_image(frag, oid, b, bo)
        parity = rs.ec_encode(media.reshape(k, cs), p,
                              device=self.device).cpu().numpy()
        jobs: List[Tuple[int, Callable[[_ServerIO], None]]] = []
        touched = set(range(bo // cs, (bo + ln - 1) // cs + 1))
        for i in sorted(touched):
            lo, hi = max(bo, i * cs), min(bo + ln, (i + 1) * cs)
            sub = frag[lo - bo:hi - bo]
            jobs.append((i, lambda s, fo=b * BLOCK + lo, sub=sub:
                         s.writev(oid, fo, [sub])))
        for j in range(p):
            jobs.append((k + j, lambda s, co=(k + j) * cs, pay=parity[j]:
                         s.update_cell(oid, b, co, pay)))
        # stale data cells neither touched nor parity: rewrite their
        # reconstructed media bytes straight onto the cell plane
        heal = pre_dirty - touched - set(range(k, k + p))
        for i in sorted(heal):
            pay = media[i * cs:(i + 1) * cs]
            jobs.append((i, lambda s, co=i * cs, pay=pay:
                         s.update_cell(oid, b, co, pay)))
        with self._map_lock:
            up = dict(self._up)
        down = [cell for cell, _fn in jobs if not up.get(order[cell])]
        stale_down = {c for c in pre_dirty if not up.get(order[c])}
        if len(set(down) | stale_down) > p:
            raise StorageError(
                f"ec({k},{p}) write would leave "
                f"{len(set(down) | stale_down)} cells dirty "
                "— stripe would fall below k clean cells")
        if down:
            self._ec_mark_dirty(oid, b, down)

        failed: List[int] = []
        flock = threading.Lock()

        def run(cell: int, fn) -> None:
            try:
                self._ec_retry(lambda: fn(self.sessions[order[cell]]))
            except StorageError:
                # cell-level failure — target down OR the single-copy
                # media commit failed: either way the cell is suspect,
                # so ledger it (idempotent) and let rebuild regenerate
                # it from survivors; parity absorbs media loss exactly
                # like target loss
                with flock:
                    failed.append(cell)
                self._ec_mark_dirty(oid, b, [cell])
                note_recovery(self._faults, "ec.cell_write_degraded")

        live = [(cell, fn) for cell, fn in jobs if cell not in down]
        quorum = min(len(live), k + 1)
        if len(live) == 1:
            run(*live[0])
        elif pre_dirty:
            # healing writes are synchronous: the ledger must only clear
            # for cells that provably landed
            pool = self._get_pool()
            for f in [pool.submit(run, cell, fn) for cell, fn in live]:
                f.result()
        else:
            pool = self._get_pool()
            futs = [pool.submit(run, cell, fn) for cell, fn in live]
            done = 0
            for f in as_completed(futs):
                f.result()
                done += 1
                if done >= quorum:
                    break
            rest = [f for f in futs if not f.done()]
            if rest:
                with self._map_lock:
                    self._ec_pending.extend(rest)
        if pre_dirty:
            landed = [c for c, _fn in live if c not in failed]
            self._ec_clear_dirty(oid, b,
                                 sorted(pre_dirty.intersection(landed)))
        if len(set(down) | set(failed)) > p:
            raise StorageError(
                f"ec({k},{p}) write lost {len(set(down) | set(failed))} "
                f"cells of block {b} — stripe below k clean cells")

    def _ec_write_block_delta(self, rs, oid: int, b: int, bo: int,
                              frag: np.ndarray, order: Sequence[int],
                              touched: Sequence[int]) -> None:
        """Delta-parity RMW: the small-write path that never reads the
        stripe. GF(256) linearity means P' = P XOR C[:, touched]·Δ with
        Δ = old XOR new over the media image of exactly the touched data
        cells — so this fetches ONLY the old bytes under the write (one
        sub-cell span per touched cell, never the untouched k-|touched|
        cells), computes the p parity deltas with the same rs_matmul kernel
        as the encoder, and ships each as ONE `xor_apply` to its parity
        target (engine-side read-modify-XOR — no per-parity-cell fetch
        round-trip). Wire bytes for a one-cell overwrite drop from
        k-cells-read + p-cells-written to 1 read + p deltas; the saving
        is accounted in `ec.delta_bytes_saved`.

        Correctness notes: stragglers are drained first (an in-flight
        ABSOLUTE parity image from a previous write would land over the
        xor'd extent with a stale base); holes read zeros so a first
        write to a sparse stripe deltas against P=0 and lands the exact
        encode; the engine aborts failed commits atomically, so the
        bounded `_ec_retry` re-reads an unchanged base. Every job runs
        synchronously — a failed cell is dirty-marked exactly like the
        full path (parity was applied for the INTENDED new data, so
        rebuild decodes the marked cell to that content)."""
        k, p, cs = self._ec
        ln = int(frag.size)
        self._ec_drain()
        # the caller judged the stripe clean BEFORE the drain — a
        # straggler that failed while draining has just ledgered a cell,
        # and delta-ing against its stale media bytes would bake the lie
        # into parity (reads decode-around the mark, so the corruption
        # would surface as wrong reconstructed bytes). Re-check.
        if self._ec_read_dirty(oid, b):
            raise _EcDeltaUnavailable("stripe went dirty during drain")
        new_media = self._ec_media_image(frag, oid, b, bo)
        # one shared cell-coordinate window [w0, w1) covers every touched
        # span: one delta row per touched cell, one xor_apply per parity
        w0 = min(max(bo, i * cs) - i * cs for i in touched)
        w1 = max(min(bo + ln, (i + 1) * cs) - i * cs for i in touched)
        deltas = np.zeros((len(touched), w1 - w0), np.uint8)
        fetched = 0
        try:
            for r, i in enumerate(touched):
                lo, hi = max(bo, i * cs), min(bo + ln, (i + 1) * cs)
                old = self._ec_retry(
                    lambda tid=order[i], lo=lo, hi=hi:
                    self.sessions[tid].fetch_cell(oid, b, lo, hi - lo))
                fetched += hi - lo
                deltas[r, lo - i * cs - w0:hi - i * cs - w0] = \
                    old ^ new_media[lo - bo:hi - bo]
        except StorageError as e:
            raise _EcDeltaUnavailable(str(e)) from e
        pdeltas = rs.ec_parity_delta(k, p, list(touched), deltas,
                                     device=self.device).cpu().numpy()
        jobs: List[Tuple[int, Callable[[_ServerIO], None]]] = []
        for i in touched:
            lo, hi = max(bo, i * cs), min(bo + ln, (i + 1) * cs)
            sub = frag[lo - bo:hi - bo]
            jobs.append((i, lambda s, fo=b * BLOCK + lo, sub=sub:
                         s.writev(oid, fo, [sub])))
        for j in range(p):
            jobs.append((k + j, lambda s, co=(k + j) * cs + w0,
                         pay=pdeltas[j]: s.xor_apply(oid, b, co, pay)))

        failed: List[int] = []
        flock = threading.Lock()

        def run(cell: int, fn) -> None:
            try:
                self._ec_retry(lambda: fn(self.sessions[order[cell]]))
            except StorageError:
                with flock:
                    failed.append(cell)
                self._ec_mark_dirty(oid, b, [cell])
                note_recovery(self._faults, "ec.cell_write_degraded")

        if len(jobs) == 1:
            run(*jobs[0])
        else:
            pool = self._get_pool()
            for f in [pool.submit(run, cell, fn) for cell, fn in jobs]:
                f.result()
        with self._map_lock:
            self.ec_delta_writes += 1
            self.ec_delta_bytes_saved += k * cs - fetched
        if len(set(failed)) > p:
            raise StorageError(
                f"ec({k},{p}) delta write lost {len(set(failed))} cells "
                f"of block {b} — stripe below k clean cells")

    def _ec_read_media_block(self, rs, oid: int, b: int) -> np.ndarray:
        """The stripe's full media-domain image (k*cs bytes, holes as
        zeros) for read-modify-write parity: clean up-cells are fetched
        raw; missing ones reconstruct from survivors. Stragglers from a
        previous quorum-acked write are joined first — the RMW base must
        be the FINAL image, or the re-encoded parity bakes in stale
        cells."""
        k, p, cs = self._ec
        self._ec_drain()
        out = np.empty(BLOCK, np.uint8)
        got = self._ec_fetch_cells(rs, oid, b, list(range(k)))
        for i in range(k):
            out[i * cs:(i + 1) * cs] = got[i]
        return out

    def _ec_gather_into(self, oid: int, offset: int,
                        dsts: Sequence) -> int:
        from repro_torch.kernels.rs_parity import ops as rs
        # JOIN stragglers, don't just harvest: at wide geometries the
        # write quorum (k+1) leaves up to p-1 cell writes in flight, and
        # a read-after-write of exactly those cells must not observe the
        # pre-write bytes (nor stale parity on a degraded decode).
        # ec(2,1) never had stragglers — quorum == job count — which is
        # why the 4-target fleet could run on a reap here.
        with tracing.span("ec.drain"):
            self._ec_drain()
        k, p, cs = self._ec
        spans, g = [], 0
        for mr, moff, sz in dsts:
            if sz > 0:
                spans.append((g, g + sz, mr, moff))
            g += sz
        size = g
        if size == 0:
            return 0
        # split the file range at BLOCK and cell boundaries; every
        # sub-fragment belongs to exactly one (block, cell)
        frags, pos, si = [], 0, 0   # (b, cell, lo, hi, [(mr, moff, sz)])
        for b, bo, ln in split_blocks(offset, size):
            for i in range(bo // cs, (bo + ln - 1) // cs + 1):
                lo, hi = max(bo, i * cs), min(bo + ln, (i + 1) * cs)
                subs = []
                while si < len(spans) and spans[si][1] <= pos + lo - bo:
                    si += 1
                j = si
                while j < len(spans) and spans[j][0] < pos + hi - bo:
                    g0, g1, mr, moff = spans[j]
                    s0 = max(pos + lo - bo, g0)
                    s1 = min(pos + hi - bo, g1)
                    subs.append((mr, moff + s0 - g0, s1 - s0))
                    j += 1
                frags.append((b, i, lo, hi, subs))
            pos += ln
        with self._map_lock:
            up = dict(self._up)
        healthy: Dict[int, List] = {}
        degraded: Dict[int, List] = {}
        for fr in frags:
            b, cell = fr[0], fr[1]
            tid = self._ec_order(oid, b)[cell]
            if up.get(tid):
                healthy.setdefault(tid, []).append(fr)
            else:
                degraded.setdefault(b, []).append(fr)

        # a batch run on the router's pool keeps the read's trace id
        trace = tracing.current_trace()

        def run_batch(tid: int, items) -> None:
            sess = self.sessions[tid]
            with (tracing.span("ec.target", trace, target=tid)
                  if tracing.ON else tracing.NOOP):
                for b, _cell, lo, _hi, subs in items:
                    self._ec_retry(
                        lambda: sess._gather_into(oid, b * BLOCK + lo, subs))

        if healthy:
            if len(healthy) == 1:
                (tid, items), = healthy.items()
                try:
                    run_batch(tid, items)
                except StorageError:
                    # target down or a cell's media unreadable: the whole
                    # batch re-routes through reconstruction
                    self._refresh_map()
                    for fr in items:
                        degraded.setdefault(fr[0], []).append(fr)
            else:
                pool = self._get_pool()
                futs = {tid: pool.submit(run_batch, tid, items)
                        for tid, items in healthy.items()}
                refreshed = False
                for tid, f in futs.items():
                    e = f.exception()
                    if isinstance(e, StorageError):
                        # cell-level failure (down target / unreadable
                        # media): the batch re-routes through
                        # reconstruction (already-filled fragments refill
                        # with identical bytes — idempotent)
                        if not refreshed:
                            self._refresh_map()
                            refreshed = True
                        for fr in healthy[tid]:
                            degraded.setdefault(fr[0], []).append(fr)
                    elif e is not None:
                        raise e
        for b in sorted(degraded):
            with tracing.span("ec.reconstruct"):
                self._ec_reconstruct_block(rs, oid, b, degraded[b])
        return size

    def _ec_fetch_cells(self, rs, oid: int, b: int,
                        want: List[int]) -> Dict[int, np.ndarray]:
        """Media-domain bytes of the wanted cells (full cs each): clean
        up-cells read raw from their homes; the rest decode from any k
        clean survivors. Raises StorageError when fewer than k clean
        cells are reachable even after one map refresh."""
        k, p, cs = self._ec
        order = self._ec_order(oid, b)
        refreshed = False
        lost: set = set()             # cells that errored under us
        while True:
            with self._map_lock:
                up = dict(self._up)
            dirty: set = set()
            for j in range(k + p):
                if not up.get(order[j]) or j in lost:
                    continue
                try:
                    marks = self._ec_retry(
                        lambda j=j: self.sessions[order[j]].read_markers(
                            oid, b, k + p))
                except StorageError:
                    lost.add(j)
                    continue
                dirty |= {i for i, byte in enumerate(marks) if byte}
            ok = [j for j in range(k + p)
                  if j not in dirty and j not in lost
                  and up.get(order[j])]
            direct = [c for c in want if c in ok]
            decode = [c for c in want if c not in ok]
            # survivors for the decode: any k clean cells — direct want
            # cells first (already being fetched, so they're free), then
            # other data cells (cheap decode), then parity
            surv = ([j for j in ok if j in direct]
                    + [j for j in ok if j < k and j not in direct]
                    + [j for j in ok if j >= k])[:k] if decode else []
            if decode and len(surv) < k:
                if not refreshed:
                    self._refresh_map()
                    refreshed, lost = True, set()
                    continue
                raise StorageError(
                    f"ec({k},{p}) block {b}: only {len(surv)} clean "
                    f"cells reachable, need {k} to reconstruct")
            got: Dict[int, np.ndarray] = {}
            died = None
            for j in sorted(set(direct) | set(surv)):
                try:
                    got[j] = self._ec_retry(
                        lambda j=j: self.sessions[order[j]].fetch_cell(
                            oid, b, j * cs, cs))
                except StorageError:
                    died = j
                    break
            if died is not None:
                # a survivor dropped mid-fetch (target down or its media
                # unreadable): exclude it and redraw
                lost.add(died)
                if not refreshed:
                    self._refresh_map()
                    refreshed = True
                continue
            out: Dict[int, np.ndarray] = {c: got[c] for c in direct}
            if decode:
                dec = rs.ec_decode(
                    np.stack([got[j] for j in surv]), surv, k, p, decode,
                    device=self.device).cpu().numpy()
                for r, c in enumerate(decode):
                    out[c] = dec[r]
                with self._map_lock:
                    self.ec_reconstructions += len(decode)
            return out

    def _ec_reconstruct_block(self, rs, oid: int, b: int,
                              wants: List) -> None:
        """Degraded read of one stripe: reconstruct the wanted cells from
        any k clean survivors, decrypt the requested ranges (back to the
        logical domain) and scatter them into the callers' buffers."""
        k, p, cs = self._ec
        cells = self._ec_fetch_cells(
            rs, oid, b, sorted({fr[1] for fr in wants}))
        nonce = oid * (1 << 20) + b
        for _b, cell, lo, hi, subs in wants:
            media = cells[cell][lo - cell * cs:hi - cell * cs]
            if self._crypto is not None:
                plain = np.asarray(self._crypto.apply(
                    media, nonce=nonce, offset=lo), np.uint8)
            else:
                plain = media
            off = 0
            for mr, moff, sz in subs:
                mr.buf[moff:moff + sz] = plain[off:off + sz]
                off += sz
        with self._map_lock:
            self.ec_degraded_reads += 1
        note_recovery(self._faults, "ec.degraded_read")

    # -- fleet-wide counters -------------------------------------------------
    def data_path_counters(self) -> Dict[str, Any]:
        """Every per-target session's counters merged fleet-wide (the
        shared `merge_counters`), the singleton subsystems (control, meta
        cache, crypto) counted ONCE, plus the router's own `cluster`
        section."""
        from dataclasses import asdict
        self._ec_drain()        # quiesce straggler cell writes first
        per = [s.data_path_counters()
               for _tid, s in sorted(self.sessions.items())]
        out = {k: merge_counters([p[k] for p in per])
               for k in ("transport", "engine", "media", "client",
                         "staging", "cq")}
        out["engine"] = merge_counters([out["engine"],
                                        asdict(self._cluster_stats())])
        # the router's own CQ (the client-level submit surface) merges
        # with the per-session CQs: ONE fleet view of submit/reap traffic
        out["cq"] = merge_counters([out["cq"], self.cq.counters()])
        out["control"] = per[0]["control"]
        # the injector is ONE fleet-shared object: report it once (summing
        # per-session copies would multiply every count by n_targets)
        for k in ("meta_cache", "crypto", "faults"):
            if k in per[0]:
                out[k] = per[0][k]
        with self._map_lock:
            out["cluster"] = {
                "targets": len(self._tids),
                "targets_up": sum(1 for u in self._up.values() if u),
                "map_version": self._map_version,
                "map_refreshes": self.map_refreshes,
                "map_invalidations": self.map_invalidations,
                "target_retries": self.target_retries,
                "retried_runs": self.retried_runs,
                "placement_cache_hits": self.placement_cache_hits,
            }
            if self._ec is not None:
                out["ec"] = {
                    "k": self._ec[0], "p": self._ec[1],
                    "degraded_reads": self.ec_degraded_reads,
                    "reconstructions": self.ec_reconstructions,
                    "rebuilt_cells":
                        int(asdict(self._cluster_stats()).get(
                            "ec_rebuilt_cells", 0)),
                    "delta_writes": self.ec_delta_writes,
                    "delta_bytes_saved": self.ec_delta_bytes_saved,
                    "delta_fallbacks": self.ec_delta_fallbacks,
                }
        return counters_registry.verify(out)

    def close(self) -> None:
        self._ec_drain()
        # reap every in-flight handle (router CQ) before the striping pool
        # and the per-target sessions retire underneath them
        self._close_submit()
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)
        for _tid, sess in sorted(self.sessions.items()):
            sess.close()


class _DPUSubmitHandle:
    """Client-level completion handle for a dpu-mode batched submission.
    The SQE does NOT ring a doorbell at submit: it queues in the owner's
    batch and crosses to the NIC when the batch fills (io_depth entries)
    or on the first wait()/flush_submits() — ONE doorbell per batch via
    DPURuntime.submit_many, the host<->NIC crossing amortization the
    offload papers measure. wait() mirrors CompletionHandle's contract
    (result or re-raised error; CancelledError after a cancel)."""

    def __init__(self, client: "ROS2Client", op: str, args: Dict[str, Any],
                 timeout: Optional[float] = None):
        self._client = client
        self.op = op
        self._args = args
        self._timeout = timeout
        self._tag: Optional[int] = None
        self._cancelled = False

    def cancel(self) -> bool:
        """Cancel iff still queued (doorbell not yet rung)."""
        return self._client._dpu_cancel(self)

    def wait(self, timeout: Optional[float] = None) -> Any:
        if self._cancelled:
            raise CancelledError(self.op)
        self._client.flush_submits()
        t = timeout if timeout is not None else self._timeout
        if t is None:
            t = self._client.timeouts.dpu_wait_s
        c = self._client.dpu.wait_tag(self._tag, timeout=t)
        if not c.ok:
            raise IOError(c.error)
        return c.result

    def result(self, timeout: Optional[float] = None) -> Any:
        return self.wait(timeout)


class ROS2Client:
    def __init__(self, mode: str = "host", transport: str = "rdma",
                 n_devices: int = 4, tenant: str = "default",
                 secret: str = "secret", inline_encryption: bool = False,
                 replication: int = 2, write_quorum: Optional[int] = None,
                 n_dpu_cores: int = 16,
                 n_staging_slots: int = 16, legacy: bool = False,
                 zero_copy: bool = True,
                 scrub_interval_s: Optional[float] = 1.0,
                 rkey_ttl_s: float = 3600.0,
                 meta_lease_s: float = 30.0,
                 lease_skew: float = 0.25,
                 renew_interval_s: Optional[float] = None,
                 n_targets: int = 1,
                 hedge_timeout_s: Optional[float] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 timeouts: Optional[Timeouts] = None,
                 ec: Optional[Tuple[int, int]] = None,
                 domains: Optional[Sequence[Optional[str]]] = None,
                 io_depth: int = 16, tcp_registered: bool = False,
                 device: DeviceLike = None):
        assert mode in ("host", "dpu") and transport in ("tcp", "rdma")
        # the CUDA card unless the caller asks for the CPU; raises before
        # anything is built when the card is asked for and absent
        self.device = resolve_device(device)
        assert n_targets >= 1
        assert n_targets == 1 or not legacy, \
            "the seed legacy path is single-target only"
        assert ec is None or (n_targets >= 2 and not legacy), \
            "ec(k,p) requires a routed multi-target cluster"
        assert domains is None or len(domains) == n_targets
        self.mode, self.transport = mode, transport
        zero_copy = zero_copy and not legacy
        self.zero_copy = zero_copy
        self.legacy = legacy
        self.tenant = tenant
        self._n_staging_slots = n_staging_slots
        self._rkey_ttl_s = rkey_ttl_s
        # submit/reap knobs: io_depth bounds in-flight ops per target (SQ
        # ring depth) and sizes the dpu-mode doorbell batch;
        # tcp_registered turns on the io_uring-style registered-buffer
        # receive leg (TCP only — RDMA reads are already zero-staging)
        self.io_depth = max(1, int(io_depth))
        self.tcp_registered = tcp_registered
        self._submit_batch: List["_DPUSubmitHandle"] = []
        self._submit_batch_lock = threading.Lock()
        # one injectable policy for every data-path wait (staging ring,
        # commit quorum/drain, DPU completions, dispatch deadline/budget)
        self.timeouts = timeouts or DEFAULT_TIMEOUTS
        # one seeded injector shared by EVERY layer boundary (transport,
        # engine, media, control, capabilities, pool-map pushes)
        self.faults = fault_injector
        # ---- storage cluster: N unchanged engines behind a pool map ----
        # (n_targets=1 is the seed shape — one engine, and `self.io` IS the
        # single _ServerIO session; n_targets>1 routes through the striped
        # _ClusterRouter with one session per target)
        self.cluster = StorageCluster(
            n_targets=n_targets, n_devices=n_devices,
            csum=crc32_checksum if legacy else None,
            timeouts=self.timeouts, domains=domains, device=self.device)
        if fault_injector is not None:
            self.cluster.set_faults(fault_injector)
        for t in self.cluster.targets:
            # extent-level hedged reads (None = off): _read_extent races
            # the second replica when the primary exceeds the budget
            t.store.hedge_timeout_s = hedge_timeout_s
        # single-target aliases (the seed names; target 0 == "the engine")
        self.store = self.cluster.targets[0].store
        self.devices = self.store.devices
        pool = self.cluster.create_pool("pool0")
        # DFS reads never pin historical epochs, so the vectored client runs
        # with epoch aggregation on; legacy keeps seed full-history extents.
        # zero_copy=False also pins the sg path's verify-every-read engine.
        self.ccontainer = pool.create_container("cont0",
                                                replication=replication,
                                                aggregate=not legacy,
                                                verified_cache=zero_copy,
                                                write_quorum=write_quorum,
                                                ec=ec)
        self.container = self.ccontainer.target(0)
        # idle-aware: the paced scrub cycles spend only media bandwidth the
        # foreground provably leaves on the table (free on loaded runs).
        # Multi-target scrubbing runs against the cluster facade (every
        # target's verified cache under one budget).
        self.scrubber = MediaScrubber(
            self.store if n_targets == 1 else self.cluster, idle_aware=True,
            device=self.device)
        # rebuild/rebalance re-replication shares the scrubber's idle-
        # aware budget: healing pauses under foreground load (bounded by
        # the same starvation floor) instead of stealing media bandwidth
        self.cluster.heal_pacer = self.scrubber
        # one server-side registry (staging ring home) per engine target
        for t in self.cluster.targets:
            t.registry = MemoryRegistry(f"server-t{t.target_id}")
        self.server_registry = self.cluster.targets[0].registry
        self.control = ControlPlane(
            self.store if n_targets == 1 else self.cluster,
            [t.registry for t in self.cluster.targets],
            tenants={tenant: secret}, meta_lease_s=meta_lease_s)
        self.meta = DFSMeta(self.store if n_targets == 1 else self.cluster)
        self.control.bind_dfs(self.meta)
        self.control.faults = fault_injector
        # ---- client side (host or DPU) ----
        self.client_registry = MemoryRegistry("dpu" if mode == "dpu"
                                              else "host")
        crypto = None
        if inline_encryption:
            # zero_copy=False disables the keystream cache too (sg-path cost)
            crypto = InlineCrypto(0xC0FFEE) if zero_copy \
                else InlineCrypto(0xC0FFEE, cache_bytes=0)
        self._crypto = crypto
        # one data-plane session per target: its own staging ring, rkey
        # grants and transport endpoint against that target's registry
        self._sessions: Dict[int, _ServerIO] = {
            t.target_id: self._new_session(t.target_id)
            for t in self.cluster.targets}
        if n_targets == 1:
            self.io = self._sessions[0]
        else:
            self.io = _ClusterRouter(
                self._sessions, self.control, self.client_registry, tenant,
                make_session=self._attach_target_session,
                cluster_stats=lambda: self.cluster.stats,
                zero_copy=zero_copy,
                faults=fault_injector, timeouts=self.timeouts,
                redundancy_key="pool0/cont0", crypto=crypto,
                io_depth=self.io_depth, device=self.device)
        # ---- session bring-up ----
        rkey, rkey_ttl = None, None
        if legacy:
            # the seed's one-RPC-per-step bring-up (the ≥4-round-trip
            # baseline the compound path is measured against)
            r = self.control.rpc("connect", tenant=tenant, secret=secret)
            if not r["ok"]:
                raise PermissionError(r["error"])
            self.session_id = r["session_id"]
            self.control.rpc("mount", session_id=self.session_id,
                             pool="pool0", container="cont0")
            if transport == "rdma":
                g = self.control.rpc("grant_rkey",
                                     session_id=self.session_id,
                                     region_id=self.io.staging.region_id,
                                     perms="rw", ttl_s=rkey_ttl_s)
                rkey = g["rkey"]
            self.cache = None
            self.io.attach_session(self.session_id, rkey, rkey_ttl,
                                   self.cache)
        else:
            # connect + mount + one grant_rkey PER TARGET (+ the pool map
            # for routed clients) in ONE compound round-trip
            ops = [{"method": "connect",
                    "args": {"tenant": tenant, "secret": secret}},
                   {"method": "mount",
                    "args": {"pool": "pool0", "container": "cont0"}}]
            grant_idx: Dict[int, int] = {}
            if transport == "rdma":
                for tid in sorted(self._sessions):
                    grant_idx[tid] = len(ops)
                    ops.append({"method": "grant_rkey", "args": {
                        "region_id":
                            self._sessions[tid].staging.region_id,
                        "perms": "rw", "ttl_s": rkey_ttl_s}})
            map_idx = None
            if n_targets > 1:
                map_idx = len(ops)
                ops.append({"method": "get_pool_map", "args": {}})
            r = self.control.rpc("compound", ops=ops)
            if r["completed"] < len(ops):
                raise PermissionError(r["results"][-1]["error"])
            self.session_id = r["session_id"]
            self.cache = MetadataCache(self.control, self.session_id,
                                       skew_margin=lease_skew)
            rkeys = {tid: r["results"][i]["rkey"]
                     for tid, i in grant_idx.items()}
            if transport == "rdma":
                rkey, rkey_ttl = rkeys.get(0), rkey_ttl_s
            if n_targets == 1:
                self.io.attach_session(self.session_id, rkey, rkey_ttl,
                                       self.cache)
            else:
                self.io.attach_session(self.session_id, rkeys, rkey_ttl,
                                       self.cache,
                                       pool_map=r["results"][map_idx])
        self.dfs = DFSClient(self.control, self.io, self.session_id,
                             cache=self.cache)
        # lease renewal runs where the client runs: DPU housekeeping on an
        # Arm core in dpu mode, a plain thread on the host
        renew_s = renew_interval_s if renew_interval_s is not None \
            else min(1.0, max(0.02, rkey_ttl_s / 10))
        self.dpu: Optional[DPURuntime] = None
        if mode == "dpu":
            self.dpu = DPURuntime(n_cores=n_dpu_cores,
                                  timeouts=self.timeouts)
            self.dpu.faults = fault_injector
            self.dpu.register("read", self.dfs.pread)
            self.dpu.register("write", self.dfs.pwrite)
            self.dpu.register("open", self.dfs.open)
            self.dpu.register("close_fd", self.dfs.close)
            self.dpu.register("stat", self.dfs.stat)
            self.dpu.register("unlink", self.dfs.unlink)
            self.dpu.register("truncate", self.dfs.truncate)
            self.dpu.register("fsync", self.dfs.fsync)
            self.dpu.register("read_into", self.dfs.pread_into)
            self.dpu.register("read_into_many", self.dfs.pread_into_many)
            self.dpu.register("readv", self.dfs.preadv)
            self.dpu.register("writev", self.dfs.pwritev)
            self.dpu.start()
            if self.cache is not None:
                self.dpu.start_housekeeping("lease-renew",
                                            self.cache.renew_due, renew_s)
        elif self.cache is not None:
            self.cache.start_renewal(renew_s)
        if zero_copy and scrub_interval_s is not None:
            # the verified cache is only honest while the scrubber bounds
            # the silent-corruption window — run it whenever the cache runs.
            # Started LAST so a failed construction never leaks the thread.
            # In dpu mode the pacing runs as DPU housekeeping on an Arm
            # core (the near-NIC background work the offload model keeps
            # off the host), same as lease renewal.
            if self.dpu is not None:
                self.dpu.start_housekeeping("media-scrub",
                                            self.scrubber.run_paced_cycle,
                                            scrub_interval_s)
            else:
                self.scrubber.start(interval_s=scrub_interval_s)

    # ---- cluster membership ----
    def _new_session(self, tid: int) -> _ServerIO:
        """Build target `tid`'s data-plane session: its container handle,
        its server registry/transport, its own staging ring — plus the
        pool-map admission check that turns a stale-routed op into a
        TargetDownError instead of silent I/O against a dead target."""
        t = self.cluster.targets[tid]
        return _ServerIO(self.ccontainer.target(tid), self.client_registry,
                         t.registry, self.transport, self.tenant,
                         self.control, self._crypto,
                         n_staging_slots=self._n_staging_slots,
                         legacy=self.legacy, zero_copy=self.zero_copy,
                         target_up=lambda tid=tid:
                             self.cluster.pool_map.is_up(tid),
                         faults=self.faults, timeouts=self.timeouts,
                         label=f"t{tid}", io_depth=self.io_depth,
                         tcp_registered=self.tcp_registered)

    def _attach_target_session(self, tid: int) -> _ServerIO:
        """Router factory for a target discovered on a map refresh
        (runtime target ADD): build the session, grant its staging rkey
        (one RPC — the target did not exist at bring-up), attach."""
        sess = self._new_session(tid)
        rkey, ttl = None, None
        if self.transport == "rdma":
            g = self.control.rpc("grant_rkey", session_id=self.session_id,
                                 region_id=sess.staging.region_id,
                                 perms="rw", ttl_s=self._rkey_ttl_s)
            if not g["ok"]:
                raise PermissionError(g["error"])
            rkey, ttl = g["rkey"], self._rkey_ttl_s
        sess.attach_session(self.session_id, rkey, ttl, self.cache)
        return sess

    def add_target(self, n_devices: Optional[int] = None,
                   domain: Optional[str] = None) -> int:
        """Grow the fleet by one engine target. The pool map bumps and is
        pushed to routed clients; jump-consistent placement moves only
        ~1/(n+1) of the keys onto the newcomer (rebalanced onto it by the
        add). Returns the target id.

        Requires a ROUTED client (n_targets >= 2 at construction): a
        single-target client's `io` is the bare _ServerIO pinned to target
        0, so the rebalance would migrate blocks it can never route to."""
        if not isinstance(self.io, _ClusterRouter):
            raise RuntimeError(
                "add_target requires a routed client — construct "
                "ROS2Client(n_targets=2+) to grow the fleet at runtime")
        t = self.cluster.add_target(n_devices, domain=domain)
        t.registry = MemoryRegistry(f"server-t{t.target_id}")
        self.control.add_registry(t.registry)
        return t.target_id

    def configure_hedged_reads(self,
                               timeout_s: Optional[float]) -> None:
        """Set (or clear, with None) the fleet-wide extent-read hedge
        budget: a replica read exceeding it races the second replica
        inside the engine's `_read_extent` (counted per extent in
        engine.hedges_issued/hedges_won)."""
        for t in self.cluster.targets:
            t.store.hedge_timeout_s = timeout_s

    # ---- POSIX-ish sync API (host launches; DPU executes in dpu mode) ----
    def _dpu_call(self, op: str, _timeout: Optional[float] = None, **args):
        """Doorbell + wait for OUR completion (tag-matched: safe under
        concurrent callers like the prefetching loader + checkpoint writer;
        generous timeout because bulk writes ahead of us in the queue may
        legitimately take tens of seconds)."""
        if _timeout is None:
            _timeout = self.timeouts.dpu_wait_s
        tag = self.dpu.submit(op, **args)
        c = self.dpu.wait_tag(tag, timeout=_timeout)
        if not c.ok:
            raise IOError(c.error)
        return c.result

    def open(self, path: str, create: bool = False) -> int:
        if self.dpu:
            return self._dpu_call("open", path=path, create=create)
        return self.dfs.open(path, create)

    # ONE routing point for the POSIX-ish data surface: every op below is
    # `_data_op(dpu_op, dfs_method, **kwargs)` — dpu mode doorbells the
    # runtime (after per-op marshalling from `_DPU_MARSHAL`, the SQE-safe
    # deep-copy rules), host mode calls the in-process DFS client. The
    # submit_* variants reuse the same marshal table, so each op's
    # dpu-vs-host shape is defined exactly once (previously triplicated
    # across this facade, core/dfs.py and the dpu handler table).
    _DPU_MARSHAL: Dict[str, Dict[str, Callable[[Any], Any]]] = {
        "write": {"data": bytes},
        "writev": {"buffers": lambda bs: [bytes(b) for b in bs]},
        "readv": {"sizes": list},
        "read_into_many": {"descs": lambda ds: [tuple(d) for d in ds]},
    }

    def _marshal(self, op: str, **args) -> Dict[str, Any]:
        for k, conv in self._DPU_MARSHAL.get(op, {}).items():
            args[k] = conv(args[k])
        return args

    def _data_op(self, op: str, dfs_name: str, **args) -> Any:
        if self.dpu:
            return self._dpu_call(op, **self._marshal(op, **args))
        return getattr(self.dfs, dfs_name)(**args)

    def pwrite(self, fd: int, data, offset: int) -> int:
        return self._data_op("write", "pwrite", fd=fd, data=data,
                             offset=offset)

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        return self._data_op("read", "pread", fd=fd, size=size,
                             offset=offset)

    def pwritev(self, fd: int, buffers: Sequence, offset: int) -> int:
        """Vectored write: the whole iovec moves as scatter-gather transport
        ops with ONE set_size control RPC (vs one per pwrite)."""
        return self._data_op("writev", "pwritev", fd=fd, buffers=buffers,
                             offset=offset)

    def preadv(self, fd: int, sizes: Sequence[int],
               offset: int) -> List[bytes]:
        """Vectored read: fills len(sizes) logically separate buffers from
        one contiguous file range with a single gather op."""
        return self._data_op("readv", "preadv", fd=fd, sizes=sizes,
                             offset=offset)

    def pread_into(self, fd: int, size: int, offset: int,
                   dst_mr, dst_off: int = 0) -> int:
        """Device-direct read into a registered region (no staging copy)."""
        return self._data_op("read_into", "pread_into", fd=fd, size=size,
                             offset=offset, dst_mr=dst_mr, dst_off=dst_off)

    def pread_into_many(self, descs: Sequence, dst_mr) -> int:
        """Vectored device-direct read: one descriptor list — [(fd, size,
        offset, dst_off)] — lands N file ranges in one registered region.
        In dpu mode the WHOLE list rides a single SQE (one doorbell, one
        completion), the batched-placement leg DeviceDirectSink uses."""
        return self._data_op("read_into_many", "pread_into_many",
                             descs=descs, dst_mr=dst_mr)

    # ---- async submit/reap (client-level) ----
    # Host mode returns DFS CompletionHandles (shared CQ, io_depth rings);
    # dpu mode returns _DPUSubmitHandles whose SQEs join the doorbell
    # batch — ONE host<->NIC crossing per io_depth queued submissions.
    def _dpu_submit(self, op: str, timeout: Optional[float],
                    **args) -> "_DPUSubmitHandle":
        h = _DPUSubmitHandle(self, op, self._marshal(op, **args),
                             timeout=timeout)
        flush = False
        with self._submit_batch_lock:
            self._submit_batch.append(h)
            flush = len(self._submit_batch) >= self.io_depth
        if flush:
            self.flush_submits()
        return h

    def flush_submits(self) -> int:
        """Ring ONE doorbell for every queued dpu-mode submission
        (DPURuntime.submit_many); host mode has nothing queued (handles
        dispatch at submit) so this is a no-op. Returns the batch size."""
        with self._submit_batch_lock:
            batch, self._submit_batch = self._submit_batch, []
        if not batch:
            return 0
        tags = self.dpu.submit_many([(h.op, h._args) for h in batch])
        for h, tag in zip(batch, tags):
            h._tag = tag
        return len(batch)

    def _dpu_cancel(self, h: "_DPUSubmitHandle") -> bool:
        with self._submit_batch_lock:
            if h in self._submit_batch:
                self._submit_batch.remove(h)
                h._cancelled = True
                return True
        return False

    def submit_pread(self, fd: int, size: int, offset: int,
                     timeout: Optional[float] = None):
        if self.dpu:
            return self._dpu_submit("read", timeout, fd=fd, size=size,
                                    offset=offset)
        return self.dfs.submit_pread(fd, size, offset, timeout=timeout)

    def submit_preadv(self, fd: int, sizes: Sequence[int], offset: int,
                      timeout: Optional[float] = None):
        if self.dpu:
            return self._dpu_submit("readv", timeout, fd=fd, sizes=sizes,
                                    offset=offset)
        return self.dfs.submit_preadv(fd, sizes, offset, timeout=timeout)

    def submit_pwritev(self, fd: int, buffers: Sequence, offset: int,
                       timeout: Optional[float] = None):
        if self.dpu:
            return self._dpu_submit("writev", timeout, fd=fd,
                                    buffers=buffers, offset=offset)
        return self.dfs.submit_pwritev(fd, buffers, offset,
                                       timeout=timeout)

    def register_region(self, nbytes_or_buf):
        """Register a client-side memory region (loader rings, sinks): a
        fresh zeroed buffer of `nbytes`, or the caller's own uint8 buffer
        (the device-direct sink's pinned ring)."""
        return self.client_registry.register(nbytes_or_buf, self.tenant)

    # async fan-out (data-loader path)
    def submit_read(self, fd: int, size: int, offset: int) -> int:
        if self.dpu:
            return self.dpu.submit("read", fd=fd, size=size, offset=offset)
        raise RuntimeError("async API requires dpu mode")

    def poll(self):
        return self.dpu.poll()

    def mkdir(self, path: str) -> None:
        self.dfs.mkdir(path)

    def close_fd(self, fd: int) -> None:
        """POSIX close: drops the handle and flushes the file's delegated
        size (ONE piggybacked set_size, the cycle's second round-trip)."""
        if self.dpu:
            self._dpu_call("close_fd", fd=fd)
        else:
            self.dfs.close(fd)

    def stat(self, path: str) -> Dict[str, Any]:
        if self.dpu:
            return self._dpu_call("stat", path=path)
        return self.dfs.stat(path)

    def unlink(self, path: str) -> None:
        if self.dpu:
            self._dpu_call("unlink", path=path)
        else:
            self.dfs.unlink(path)

    def truncate(self, path: str, size: int) -> Dict[str, Any]:
        if self.dpu:
            return self._dpu_call("truncate", path=path, size=size)
        return self.dfs.truncate(path, size)

    def fsync(self, fd: int) -> None:
        if self.dpu:
            self._dpu_call("fsync", fd=fd)
        else:
            self.dfs.fsync(fd)

    def close(self) -> None:
        try:                         # delegated sizes must land before exit
            self.dfs.flush_meta()
        except DFSError:
            pass                     # e.g. every pending path was unlinked
        if self.cache is not None:
            self.cache.stop_renewal()
        self.scrubber.stop()
        if self.dpu:
            # never-doorbelled queued submissions die with the client
            with self._submit_batch_lock:
                dropped, self._submit_batch = self._submit_batch, []
            for h in dropped:
                h._cancelled = True
            self.dpu.stop()
        # persistent client registrations (loader rings, raw read sinks
        # the caller never deregistered) die with the client: capability
        # first, then the registration, so no stale NIC translation-cache
        # entry can land bytes in recycled memory
        for mr in self.client_registry.regions():
            self.io.drop_dst_rkey(mr)
            self.client_registry.deregister(mr)
        # drain the CQ(s) and retire submit pools — router AND the bare
        # single-target session both expose close() now
        self.io.close()
        self.cluster.close()   # drain background replica commits fleet-wide

    # ---- calibrated performance model ----
    def stations(self, io_size: int, write: bool,
                 client_cores: Optional[int] = None,
                 server_cores: int = tm.SRV_CORES_DEFAULT) -> List[Station]:
        """One client's service-demand pipeline. Multi-target clients
        stripe across every engine's cores and devices (server CPU and
        media capacity scale with the fleet); the network station stays a
        single link — one client cannot exceed its own NIC, which is
        exactly why fleet-capacity numbers (bench_data_path's `cluster`
        section) multiply the per-target pipeline by the placement spread
        instead of modeling one giant client."""
        plat = tm.DPU if self.mode == "dpu" else tm.HOST
        cores = client_cores or plat.n_cores
        n_targets = len(self.cluster.targets)
        return (tm.client_stations(plat, self.transport, io_size, write,
                                   cores)
                + tm.network_stations(io_size)
                + tm.server_stations(self.transport, io_size, write,
                                     server_cores * n_targets)
                + striped_stations(self.cluster.devices, io_size, write))

    def model_throughput(self, io_size: int, write: bool, jobs: int,
                         iodepth: int = 8, **kw) -> float:
        """Modeled B/s for a FIO-like closed workload."""
        x, _ = mva(self.stations(io_size, write, **kw), jobs * iodepth)
        return x * io_size

    def model_iops(self, io_size: int, write: bool, jobs: int,
                   iodepth: int = 8, **kw) -> float:
        x, _ = mva(self.stations(io_size, write, **kw), jobs * iodepth)
        return x


def media_image(client: ROS2Client) -> Dict[Tuple[int, str, int], bytes]:
    """The committed on-media image of a client's fleet: every block of
    every alive device of every up target, after writeback, as
    {(target, device, key): bytes}. Background writes must have drained
    first (`data_path_counters()` joins EC stragglers). Two clients fed
    the same operations hold the same image."""
    image: Dict[Tuple[int, str, int], bytes] = {}
    for t in client.cluster.targets:
        if not client.cluster.pool_map.is_up(t.target_id):
            continue
        for d in t.store.devices:
            if not d.alive:
                continue
            d.writeback()
            with d._lock:
                blocks = dict(d._blocks)
            for key, payload in blocks.items():
                image[(t.target_id, d.name, key)] = bytes(payload)
    return image
