"""Data plane: memory registration + TCP/RDMA transports.

The functional semantics preserve exactly what distinguishes the two
transports in the paper:

  * RDMA: one-sided. The initiator must hold a valid, unexpired rkey scoped
    to the target region and tenant (protection domain); bytes then move
    with a SINGLE copy (memoryview splice — "NIC DMA"), eagerly for small
    messages and via a rendezvous exchange (RTS/CTS control messages) for
    bulk, without any target-CPU byte handling.
  * TCP: two-sided, kernel-mediated. Bytes are segmented into MTU frames and
    staged through a bounded kernel buffer: TWO copies per byte plus
    per-segment processing on both ends.

Vectored (scatter-gather) data path: `read_sg`/`write_sg` take an iovec of
N descriptors sharing one remote rkey/region. Over RDMA the whole bulk op
costs ONE rkey resolution (with an rkey-resolution cache modeling the NIC's
MPT/MTT translation cache across ops) and ONE rendezvous RTS/CTS exchange —
the offload-engine scatter-gather the paper's data path depends on. Over
TCP each descriptor remains an independently requested, MTU-segmented,
double-copied stream, so the counters still discriminate the transports.

Server-initiated placement (`place_sg`): the GPUDirect-style direct
splice. The initiator registers its destination memory, grants an rkey on
it, and conveys the token with the read request; the server validates the
capability (tenant/perms/expiry/bounds — revocation bites even on cached
translations) and then scatters engine bytes STRAIGHT into the initiator's
region, one copy per byte, no staging bounce. The storage engine performs
the fill through the views `place_sg` hands back — the "NIC DMA" of a
server-side RDMA WRITE into caller memory.

Counters (copies, segments, control messages, sg_ops, descriptors,
rkey_resolves, bytes) let tests assert these semantics; throughput numbers
come from the MVA model (core/sim.py), not wall-clock.
"""
from __future__ import annotations

import itertools
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MTU = 9000
EAGER_LIMIT = 16 * 1024
KERNEL_BUF = 256 * 1024


class AccessError(Exception):
    pass


@dataclass
class MemoryRegion:
    region_id: int
    buf: np.ndarray                # uint8
    tenant: str

    @property
    def size(self) -> int:
        return self.buf.size


@dataclass
class RKey:
    token: str
    region_id: int
    tenant: str                    # protection domain
    perms: str                     # "r", "w", "rw"
    expires_at: float              # monotonic deadline
    revoked: bool = False


# Region ids are unique across EVERY registry in the process (not merely
# per registry): a multi-target cluster runs one server registry per
# engine target, and the control plane's grant/renew RPCs address regions
# by id alone — colliding per-registry counters would let a grant land on
# the wrong target's region.
_region_ids = itertools.count(1)


class MemoryRegistry:
    """Registered regions + scoped rkeys (one per side of the wire)."""

    def __init__(self, name: str):
        self.name = name
        self._regions: Dict[int, MemoryRegion] = {}
        self._rkeys: Dict[str, RKey] = {}
        self._lock = threading.Lock()

    def register(self, nbytes_or_buf, tenant: str) -> MemoryRegion:
        rid = next(_region_ids)
        buf = (np.zeros(nbytes_or_buf, np.uint8)
               if isinstance(nbytes_or_buf, int) else nbytes_or_buf)
        mr = MemoryRegion(rid, buf, tenant)
        self._regions[rid] = mr
        return mr

    def deregister(self, mr: MemoryRegion) -> None:
        self._regions.pop(mr.region_id, None)

    def regions(self) -> List[MemoryRegion]:
        """Snapshot of live registrations (owner teardown sweeps)."""
        return list(self._regions.values())

    def grant(self, mr: MemoryRegion, perms: str = "rw",
              ttl_s: float = 3600.0) -> RKey:
        rk = RKey(secrets.token_hex(8), mr.region_id, mr.tenant, perms,
                  time.monotonic() + ttl_s)
        self._rkeys[rk.token] = rk
        return rk

    def renew(self, token: str, ttl_s: float = 3600.0) -> RKey:
        """Lease renewal: extend a live key's expiry IN PLACE. The token —
        and any NIC translation-cache entry holding the same RKey object —
        stays valid, which is what lets a client renew ahead of expiry
        without invalidating its cached resolutions. Revoked keys are not
        resurrectable: revocation is a security decision, renewal is not."""
        rk = self._rkeys.get(token)
        if rk is None:
            raise KeyError("unknown rkey")
        if rk.revoked:
            raise AccessError("rkey revoked")
        rk.expires_at = time.monotonic() + ttl_s
        return rk

    def revoke(self, token: str) -> None:
        rk = self._rkeys.get(token)
        if rk:
            rk.revoked = True

    def retire(self, token: str) -> None:
        """Forget a key entirely (capability teardown for short-lived
        grants): the token resolves as unknown afterwards — the same hard
        failure as revocation — and, unlike revoke, the entry does not
        linger in the table, so per-op grants cannot grow it unboundedly."""
        self._rkeys.pop(token, None)

    def lookup(self, token: str) -> Tuple[RKey, MemoryRegion]:
        """Translate a token to its key + region (the cacheable MPT/MTT
        lookup); key-state/PD/bounds checks happen in `check_access`."""
        rk = self._rkeys.get(token)
        if rk is None:
            raise AccessError("unknown rkey")
        mr = self._regions.get(rk.region_id)
        if mr is None:
            raise AccessError("rkey region deregistered")
        return rk, mr

    @staticmethod
    def check_access(rk: RKey, mr: MemoryRegion, tenant: str, offset: int,
                     size: int, op: str) -> None:
        if rk.revoked:
            raise AccessError("rkey revoked")
        if time.monotonic() > rk.expires_at:
            raise AccessError("rkey expired")
        if rk.tenant != tenant:
            raise AccessError(
                f"protection-domain violation: {tenant} != {rk.tenant}")
        if op not in rk.perms:
            raise AccessError(f"rkey lacks '{op}' permission")
        if offset < 0 or offset + size > mr.size:
            raise AccessError("access outside registered region")

    def resolve(self, token: str, tenant: str, offset: int, size: int,
                op: str) -> MemoryRegion:
        rk, mr = self.lookup(token)
        self.check_access(rk, mr, tenant, offset, size, op)
        return mr


@dataclass
class TransportStats:
    bytes_moved: int = 0
    copies: int = 0                # byte-copies performed (per byte counted once)
    copy_bytes: int = 0
    segments: int = 0
    control_msgs: int = 0
    ops: int = 0
    rendezvous: int = 0
    eager: int = 0
    sg_ops: int = 0                # vectored (scatter-gather) ops
    descriptors: int = 0           # iovec entries across all sg ops
    rkey_resolves: int = 0         # registry translations actually performed
    rkey_cache_hits: int = 0       # translations served from the NIC cache
    sendmsg_batches: int = 0       # TCP iovec batches (1 syscall-equivalent)
    placements: int = 0            # server-initiated direct-splice ops
    placed_bytes: int = 0          # bytes landed by direct placement
    registered_read_bytes: int = 0  # TCP read bytes landed via the
    # registered-buffer leg (single copy, no kernel staging bounce)


# One scatter-gather descriptor: (remote_offset, local_mr, local_offset, size)
SGDescriptor = Tuple[int, MemoryRegion, int, int]


class RDMATransport:
    """One-sided verbs-style transport between two registries.

    Scalar `read`/`write` resolve the rkey through the registry on every op
    (the seed behavior). The vectored `read_sg`/`write_sg` verbs move an
    entire iovec as ONE bulk op: one rkey translation (served from a
    per-transport resolution cache after the first op — the NIC's MPT/MTT
    cache), one eager-or-rendezvous decision for the summed length, and one
    splice per descriptor (still exactly one copy per byte)."""

    def __init__(self, local: MemoryRegistry, remote: MemoryRegistry):
        self.local = local
        self.remote = remote
        self.stats = TransportStats()
        # optional FaultInjector (core.faults): "transport.*" rules model
        # link anomalies on the vectored verbs — error (op fails before
        # any byte moves), partial (a prefix lands, then the op fails),
        # delay. Initiator-side hardening retries the op, RC-retransmit
        # style; SG ops are idempotent so a partial retry is safe.
        self.faults = None
        # token -> (key, region, owning registry): one cache serves both
        # directions (initiator-side rkeys for server-initiated placement
        # live in `local`, target-side rkeys in `remote`)
        self._rkey_cache: Dict[str, Tuple[RKey, MemoryRegion,
                                          MemoryRegistry]] = {}
        self._stats_lock = threading.Lock()

    def _sg_fault(self, op: str, partial=None) -> None:
        """Evaluate injected anomalies for one SG op (no-op unwired)."""
        if self.faults is None:
            return
        f = self.faults.pick(f"transport.{op}")
        if f is None or f.kind == "delay":
            return
        if f.kind == "partial" and partial is not None:
            partial()                 # a prefix of the op's bytes lands
        raise f.make_exc(f"transport.{op}")

    def _splice(self, src: np.ndarray, so: int, dst: np.ndarray, do: int,
                size: int) -> None:
        dst[do:do + size] = src[so:so + size]     # single copy ("NIC DMA")
        with self._stats_lock:                    # concurrent SG readers
            self.stats.copies += 1
            self.stats.copy_bytes += size
            self.stats.bytes_moved += size

    def _resolve_cached(self, rkey: str, tenant: str, op: str,
                        registry: Optional[MemoryRegistry] = None
                        ) -> MemoryRegion:
        """Cached rkey translation; key-state/PD checks still run on every
        use (revocation/expiry must bite even on cache hits), and the
        cached entry is dropped if its region was deregistered (MPT
        invalidation on dereg). Per-descriptor bounds checks happen in
        _sg_setup. `registry` selects which side's keys translate: the
        target's (`remote`, default — initiator-driven verbs) or the
        initiator's (`local` — server-initiated placement)."""
        reg = registry if registry is not None else self.remote
        with self._stats_lock:
            ent = self._rkey_cache.get(rkey)
            if ent is None:
                rk, mr = reg.lookup(rkey)
                ent = (rk, mr, reg)
                self._rkey_cache[rkey] = ent
                self.stats.rkey_resolves += 1
            else:
                self.stats.rkey_cache_hits += 1
        rk, mr, reg = ent
        if reg._regions.get(rk.region_id) is not mr:
            self.invalidate_rkey_cache(rkey)
            raise AccessError("rkey region deregistered")
        reg.check_access(rk, mr, tenant, 0, 0, op)
        return mr

    def invalidate_rkey_cache(self, rkey: Optional[str] = None) -> None:
        if rkey is None:
            self._rkey_cache.clear()
        else:
            self._rkey_cache.pop(rkey, None)

    def read(self, rkey: str, tenant: str, roff: int,
             local_mr: MemoryRegion, loff: int, size: int) -> None:
        mr = self.remote.resolve(rkey, tenant, roff, size, "r")
        with self._stats_lock:
            self.stats.rkey_resolves += 1
            self.stats.ops += 1
            if size > EAGER_LIMIT:
                self.stats.rendezvous += 1
                self.stats.control_msgs += 2      # RTS/CTS
            else:
                self.stats.eager += 1
        self._splice(mr.buf, roff, local_mr.buf, loff, size)

    def write(self, rkey: str, tenant: str, roff: int,
              local_mr: MemoryRegion, loff: int, size: int) -> None:
        mr = self.remote.resolve(rkey, tenant, roff, size, "w")
        with self._stats_lock:
            self.stats.rkey_resolves += 1
            self.stats.ops += 1
            if size > EAGER_LIMIT:
                self.stats.rendezvous += 1
                self.stats.control_msgs += 2
            else:
                self.stats.eager += 1
        self._splice(local_mr.buf, loff, mr.buf, roff, size)

    # -- vectored verbs ------------------------------------------------------
    def _sg_setup(self, rkey: str, tenant: str, op: str,
                  iov: Sequence[SGDescriptor]) -> MemoryRegion:
        total = sum(d[3] for d in iov)
        mr = self._resolve_cached(rkey, tenant, op)
        for roff, _lmr, _loff, size in iov:       # per-descriptor bounds
            if roff < 0 or roff + size > mr.size:
                raise AccessError("sg descriptor outside registered region")
        with self._stats_lock:
            self.stats.ops += 1
            self.stats.sg_ops += 1
            self.stats.descriptors += len(iov)
            if total > EAGER_LIMIT:
                self.stats.rendezvous += 1        # ONE RTS/CTS for the op
                self.stats.control_msgs += 2
            else:
                self.stats.eager += 1
        return mr

    def read_sg(self, rkey: str, tenant: str,
                iov: Sequence[SGDescriptor]) -> int:
        """Gather-read: remote region -> N local destinations, one bulk op."""
        mr = self._sg_setup(rkey, tenant, "r", iov)
        if iov:
            r0, l0, o0, s0 = iov[0]
            self._sg_fault("read_sg", partial=lambda: self._splice(
                mr.buf, r0, l0.buf, o0, s0))
        for roff, lmr, loff, size in iov:
            self._splice(mr.buf, roff, lmr.buf, loff, size)
        return sum(d[3] for d in iov)

    def write_sg(self, rkey: str, tenant: str,
                 iov: Sequence[SGDescriptor]) -> int:
        """Scatter-write: N local sources -> remote region, one bulk op."""
        mr = self._sg_setup(rkey, tenant, "w", iov)
        if iov:
            r0, l0, o0, s0 = iov[0]
            self._sg_fault("write_sg", partial=lambda: self._splice(
                l0.buf, o0, mr.buf, r0, s0))
        for roff, lmr, loff, size in iov:
            self._splice(lmr.buf, loff, mr.buf, roff, size)
        return sum(d[3] for d in iov)

    # -- server-initiated placement (direct read splice) ---------------------
    def place_sg(self, rkey: str, tenant: str,
                 spans: Sequence[Tuple[int, int]]) -> List[np.ndarray]:
        """Server-initiated scatter placement: validate the initiator's
        destination capability ONCE for the op (cached translation, checks
        on every use) and hand back one writable view per (offset, size)
        span. The storage engine scatters the extent overlay straight into
        these views — the single "NIC DMA" copy per byte of a server-side
        RDMA WRITE into caller-registered memory; no staging bounce ever
        exists for the op. Accounting mirrors read_sg: one op, one
        eager-or-rendezvous decision for the summed length, one descriptor
        per span, and exactly one counted copy per byte (charged here, at
        placement grant time — the fill IS the DMA)."""
        self._sg_fault("place_sg")    # before any grant: retry re-derives
        mr = self._resolve_cached(rkey, tenant, "w", registry=self.local)
        total = sum(s for _, s in spans)
        for roff, size in spans:
            if roff < 0 or roff + size > mr.size:
                raise AccessError("sg descriptor outside registered region")
        with self._stats_lock:
            self.stats.ops += 1
            self.stats.sg_ops += 1
            self.stats.descriptors += len(spans)
            self.stats.placements += 1
            self.stats.placed_bytes += total
            if total > EAGER_LIMIT:
                self.stats.rendezvous += 1        # ONE RTS/CTS for the op
                self.stats.control_msgs += 2
            else:
                self.stats.eager += 1
            self.stats.copies += len(spans)
            self.stats.copy_bytes += total
            self.stats.bytes_moved += total
        return [mr.buf[roff:roff + size] for roff, size in spans]


class TCPTransport:
    """Two-copy, segmented, kernel-buffered transport (no rkeys needed —
    and no protection-domain enforcement either, which is the point).

    The bounded kernel buffer is shared by all streams on the connection:
    `_kbuf_lock` is held for the duration of each MTU segment's two copies
    (the kernel's per-socket-buffer serialization), so concurrent streams
    (the engine no longer serializes transports behind one lock) cannot
    corrupt in-flight data.

    `read_sg`/`write_sg` exist for API parity with RDMA, but TCP has no
    scatter-gather offload for the DATA: every descriptor is still an
    MTU-segmented, double-copied stream. With `sendmsg_batching=True`
    (default) the CONTROL side models `sendmsg`/`recvmsg` iovec batching —
    the whole sg op's descriptor list ships as ONE request message (one
    syscall-equivalent), the way a real client coalesces an iovec into a
    single msghdr. Copies and segments are untouched, so the counters keep
    discriminating the transports; `sendmsg_batching=False` reproduces the
    sg path's per-descriptor request tax.

    `registered=True` models the io_uring registered-buffer receive leg:
    READ payloads whose destinations were registered up front land with
    ONE copy per byte (kernel -> pinned user pages, no staging bounce
    through the shared socket buffer), counted in
    `registered_read_bytes`. MTU segmentation and the request-message
    economy are unchanged, and the WRITE side keeps the classic two-copy
    stream — registration helps the receive path only."""

    def __init__(self, local: MemoryRegistry, remote: MemoryRegistry,
                 sendmsg_batching: bool = True, registered: bool = False):
        self.local = local
        self.remote = remote
        self.sendmsg_batching = sendmsg_batching
        self.registered = registered
        self.stats = TransportStats()
        self.faults = None            # optional FaultInjector (core.faults)
        self._kernel_buf = np.zeros(KERNEL_BUF, np.uint8)
        self._kbuf_lock = threading.Lock()

    def _sg_fault(self, op: str, partial=None) -> None:
        """Injected link anomalies, mirroring RDMATransport._sg_fault."""
        if self.faults is None:
            return
        f = self.faults.pick(f"transport.{op}")
        if f is None or f.kind == "delay":
            return
        if f.kind == "partial" and partial is not None:
            partial()
        raise f.make_exc(f"transport.{op}")

    def _stream(self, src: np.ndarray, so: int, dst: np.ndarray, do: int,
                size: int) -> None:
        sent = 0
        while sent < size:
            seg = min(MTU, size - sent, KERNEL_BUF)
            with self._kbuf_lock:                 # exclusive kernel staging
                # copy 1: user -> kernel
                self._kernel_buf[:seg] = src[so + sent:so + sent + seg]
                # copy 2: kernel -> user
                dst[do + sent:do + sent + seg] = self._kernel_buf[:seg]
                self.stats.copies += 2
                self.stats.copy_bytes += 2 * seg
                self.stats.segments += 1
            sent += seg
        with self._kbuf_lock:
            self.stats.bytes_moved += size

    def _stream_registered(self, src: np.ndarray, so: int, dst: np.ndarray,
                           do: int, size: int) -> None:
        """Registered-buffer receive leg: the destination pages are pinned
        up front, so each MTU segment is ONE kernel->user copy straight
        into them — the staging bounce `_stream` pays is gone. The stats
        lock still serializes segments (per-socket-buffer ordering)."""
        sent = 0
        while sent < size:
            seg = min(MTU, size - sent, KERNEL_BUF)
            with self._kbuf_lock:
                dst[do + sent:do + sent + seg] = src[so + sent:so + sent + seg]
                self.stats.copies += 1
                self.stats.copy_bytes += seg
                self.stats.segments += 1
            sent += seg
        with self._kbuf_lock:
            self.stats.bytes_moved += size
            self.stats.registered_read_bytes += size

    def _recv_stream(self):
        """The receive-leg stream in force: registered (single-copy) or
        classic kernel-staged (two-copy)."""
        return self._stream_registered if self.registered else self._stream

    def read(self, region: MemoryRegion, roff: int, local_mr: MemoryRegion,
             loff: int, size: int) -> None:
        with self._kbuf_lock:
            self.stats.ops += 1
            self.stats.control_msgs += 1          # request message
        self._recv_stream()(region.buf, roff, local_mr.buf, loff, size)

    def write(self, region: MemoryRegion, roff: int, local_mr: MemoryRegion,
              loff: int, size: int) -> None:
        with self._kbuf_lock:
            self.stats.ops += 1
            self.stats.control_msgs += 1
        self._stream(local_mr.buf, loff, region.buf, roff, size)

    def _sg_control(self, iov: Sequence[SGDescriptor]) -> None:
        """Request-message accounting for a vectored op: one batched
        sendmsg for the whole iovec, or one request per descriptor."""
        self.stats.ops += 1
        self.stats.sg_ops += 1
        self.stats.descriptors += len(iov)
        if self.sendmsg_batching:
            self.stats.control_msgs += 1
            self.stats.sendmsg_batches += 1
        else:
            self.stats.control_msgs += len(iov)

    # -- vectored API parity (data: per-descriptor double-copied streams) ----
    def read_sg(self, region: MemoryRegion,
                iov: Sequence[SGDescriptor]) -> int:
        recv = self._recv_stream()
        with self._kbuf_lock:                     # concurrent SG callers
            self._sg_control(iov)
        if iov:
            r0, l0, o0, s0 = iov[0]
            self._sg_fault("read_sg", partial=lambda: recv(
                region.buf, r0, l0.buf, o0, s0))
        for roff, lmr, loff, size in iov:
            recv(region.buf, roff, lmr.buf, loff, size)
        return sum(d[3] for d in iov)

    def write_sg(self, region: MemoryRegion,
                 iov: Sequence[SGDescriptor]) -> int:
        with self._kbuf_lock:
            self._sg_control(iov)
        if iov:
            r0, l0, o0, s0 = iov[0]
            self._sg_fault("write_sg", partial=lambda: self._stream(
                l0.buf, o0, region.buf, r0, s0))
        for roff, lmr, loff, size in iov:
            self._stream(lmr.buf, loff, region.buf, roff, size)
        return sum(d[3] for d in iov)
