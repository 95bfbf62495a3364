"""Storage media: functional block devices + calibrated performance models.

Functional side: an NVMe/SCM device stores real bytes (sparse extent dict)
and is the backing store for the object store. Performance side: per-device
service-demand constants calibrated to the paper's Fig. 3 local ceilings:

    1 SSD, 1 MiB: seq/rand read ~5.0-5.6 GiB/s, write ~2.7 GiB/s
    4 SSD, 1 MiB: read ~20-22 GiB/s, write ~10.6-10.7 GiB/s (linear)
    4 KiB IOPS:   ~80 K @1 job -> ~600 K @16 jobs, drive-count insensitive
                  (host submission path limit, not media)
"""
from __future__ import annotations

import threading
import zlib
from dataclasses import dataclass, field
from functools import lru_cache
from time import sleep as time_sleep
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.sim import GiB, KiB, MiB, Station


@dataclass
class MediaPerf:
    read_bw: float = 5.6 * GiB          # per-device large-block read B/s
    write_bw: float = 2.7 * GiB         # per-device large-block write B/s
    op_latency_s: float = 80e-6         # media access latency (delay station)
    op_overhead_s: float = 1.0e-6       # per-op media controller cost
    internal_parallelism: int = 16      # NAND channel concurrency


SCM_PERF = MediaPerf(read_bw=30 * GiB, write_bw=20 * GiB,
                     op_latency_s=2e-6, op_overhead_s=0.2e-6,
                     internal_parallelism=8)


class _DonatedBlock:
    """A block whose payload is a caller-donated buffer (a staging-ring
    slot view): zero host copies at commit. The lease pin keeps the slot
    out of the ring's free list until `writeback` programs the block into
    the device's private store ("NAND program" — the DMA a real NVMe
    performs from the pinned host buffer, not a host-CPU data-path copy)."""

    __slots__ = ("arr", "lease")

    def __init__(self, arr: "np.ndarray", lease) -> None:
        self.arr = arr
        self.lease = lease


class Device:
    """A functional block device holding real bytes.

    `write` accepts bytes / memoryview / ndarray. With `lease=None`,
    non-bytes input is materialized (counted in `host_copy_bytes` — the
    per-replica private copy the zero-copy path eliminates). With a lease,
    the buffer is DONATED: stored by reference with zero copies, the lease
    pinned until `writeback()` (triggered by reads of the block, staging-
    ring pressure, or device failure) lands the bytes in the private store
    and releases the slot back to the ring. `generation` bumps on every
    fail/recover so verified-extent caches keyed on it self-invalidate."""

    def __init__(self, name: str, capacity: int, perf: MediaPerf,
                 kind: str = "nvme"):
        self.name = name
        self.capacity = capacity
        self.perf = perf
        self.kind = kind
        self._blocks: Dict[int, object] = {}    # key -> bytes | _DonatedBlock
        self._lock = threading.Lock()
        self.alive = True
        self.generation = 0
        self.bytes_written = 0
        self.bytes_read = 0
        self.host_copy_bytes = 0       # data-path copies made at commit
        self.donated_bytes = 0         # bytes committed by buffer donation
        self.writeback_bytes = 0       # deferred NAND programs of donations
        # injectable per-commit latency (seconds): benchmarks/tests make
        # THIS device the slow replica to show quorum-ack writes tracking
        # the fastest majority instead of the straggler
        self.commit_delay_s = 0.0
        # injectable per-read latency: makes THIS device the straggler the
        # engine's extent-level hedged reads race against
        self.read_delay_s = 0.0
        # optional FaultInjector (core.faults) shared with the engine: its
        # "media.write"/"media.read" rules raise I/O errors here, BEFORE
        # any mutation — the committer's exactly-once pin-release contract
        # below holds for injected failures identically to real ones
        self.faults = None

    def write(self, key: int, data, lease=None, pre_pinned: bool = False)\
            -> None:
        """Commit a block. `pre_pinned=True` means the caller already took
        this device's pin on the lease (the quorum committer pins every
        planned replica up front on the op thread, so a donated slot can
        never be freed between the op returning at quorum and a straggler
        replica starting its background commit). On ANY failure the pin is
        left untouched — the committer owns releasing it, exactly once."""
        if self.faults is not None:
            self.faults.fire("media.write", dev=self.name)
        if self.commit_delay_s:
            time_sleep(self.commit_delay_s)
        if not self.alive:
            raise IOError(f"device {self.name} failed")
        if lease is not None:
            arr = data if isinstance(data, np.ndarray) \
                else np.frombuffer(data, np.uint8)
            if not pre_pinned:
                lease.pin()
            with self._lock:
                self._blocks[key] = _DonatedBlock(arr, lease)
                self.bytes_written += arr.size
                self.donated_bytes += arr.size
            return
        # materialize outside the lock: concurrent writers to one device
        # serialize only on the dict insert, not on the byte copy
        if isinstance(data, bytes):
            payload = data
            copied = 0
        else:
            payload = bytes(data)
            copied = len(payload)
        with self._lock:
            self._blocks[key] = payload
            self.bytes_written += len(payload)
            self.host_copy_bytes += copied

    def _writeback_entry(self, key: int, entry: _DonatedBlock) -> bytes:
        """Program a donated buffer into the private store and release its
        staging-ring lease. Caller holds self._lock. Replicas of the same
        donation share ONE materialization (stashed on the lease): the
        bytes leave the ring buffer once, like the single host buffer all
        replica DMAs source from."""
        payload = entry.lease.materialized
        if payload is None:
            payload = entry.arr.tobytes()
            entry.lease.materialized = payload
            self.writeback_bytes += len(payload)
        self._blocks[key] = payload
        entry.lease.unpin()
        return payload

    def writeback(self, limit_bytes: Optional[int] = None) -> int:
        """Flush donated blocks to the private store (releasing their
        leases); returns bytes written back. `limit_bytes` bounds the
        flush for pressure-driven partial reclaims."""
        done = 0
        with self._lock:
            for key, entry in list(self._blocks.items()):
                if not isinstance(entry, _DonatedBlock):
                    continue
                done += len(self._writeback_entry(key, entry))
                if limit_bytes is not None and done >= limit_bytes:
                    break
        return done

    def read(self, key: int) -> bytes:
        if self.faults is not None:
            self.faults.fire("media.read", dev=self.name)
        if self.read_delay_s:
            time_sleep(self.read_delay_s)
        if not self.alive:
            raise IOError(f"device {self.name} failed")
        with self._lock:
            data = self._blocks.get(key)
            if data is None:
                raise KeyError(f"{self.name}: no block {key}")
            if isinstance(data, _DonatedBlock):
                # first read completes the deferred NAND program, so the
                # returned bytes never alias the (reusable) ring slot
                data = self._writeback_entry(key, data)
            self.bytes_read += len(data)
            return data

    def delete(self, key: int) -> None:
        with self._lock:
            entry = self._blocks.pop(key, None)
        if isinstance(entry, _DonatedBlock):
            entry.lease.unpin()

    def fail(self) -> None:
        # land in-flight donations first so their ring slots come back even
        # while the device is down (the data survives for recover())
        self.writeback()
        self.generation += 1
        self.alive = False

    def recover(self) -> None:
        self.generation += 1
        self.alive = True

    def used_bytes(self) -> int:
        with self._lock:
            return sum(b.arr.size if isinstance(b, _DonatedBlock) else len(b)
                       for b in self._blocks.values())

    # -- performance model -------------------------------------------------
    def stations(self, io_size: int, write: bool) -> List[Station]:
        bw = self.perf.write_bw if write else self.perf.read_bw
        return [
            Station(f"{self.name}:xfer", io_size / bw, servers=1),
            Station(f"{self.name}:ctrl", self.perf.op_overhead_s,
                    servers=self.perf.internal_parallelism),
            Station(f"{self.name}:lat", self.perf.op_latency_s, kind="delay"),
        ]


def make_nvme_array(n: int, capacity_per_dev: int = 1600 * GiB,
                    prefix: str = "") -> List[Device]:
    """`prefix` namespaces device names (e.g. "t1.") so a multi-target
    cluster's fleet-wide facades can address devices unambiguously."""
    return [Device(f"{prefix}nvme{i}", capacity_per_dev, MediaPerf())
            for i in range(n)]


def striped_stations(devices: List[Device], io_size: int,
                     write: bool) -> List[Station]:
    """I/O striped across an array: aggregate bandwidth, shared latency."""
    n = max(1, len(devices))
    p = devices[0].perf
    bw = (p.write_bw if write else p.read_bw) * n
    return [
        Station("ssd:xfer", io_size / bw, servers=1),
        Station("ssd:ctrl", p.op_overhead_s,
                servers=p.internal_parallelism * n),
        Station("ssd:lat", p.op_latency_s, kind="delay"),
    ]


@lru_cache(maxsize=32)
def _fletcher_weights(n_words: int) -> "np.ndarray":
    return np.arange(n_words, 0, -1, dtype=np.uint32)


def fletcher64(data) -> int:
    """Vectorized Fletcher-64 extent checksum over little-endian u32 words
    (zero-padded), identical to the port's fletcher kernel
    (`kernels/fletcher`) and its fletcher_np oracle: s1 = sum w_i mod 2^32, s2 = sum (N-i) w_i mod 2^32, packed
    (s2 << 32) | s1. Unlike CRC's bit-serial polynomial division this is
    three SIMD passes, so the engine's per-replica-read verify costs
    ~0.5 ms/MiB instead of ~1.2 ms/MiB on this host."""
    buf = (data if isinstance(data, np.ndarray)
           else np.frombuffer(data, np.uint8))
    pad = (-buf.size) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, np.uint8)])
    w = np.ascontiguousarray(buf).view("<u4")
    s1 = int(w.sum(dtype=np.uint64)) & 0xFFFFFFFF
    with np.errstate(over="ignore"):
        # products mod 2^32 via native uint32 wraparound, summed in u64
        s2 = int((w * _fletcher_weights(w.size)).sum(
            dtype=np.uint64)) & 0xFFFFFFFF
    return (s2 << 32) | s1


def crc32_checksum(data) -> int:
    """The seed's scalar CRC32 extent checksum; kept for the `legacy=True`
    data path so benchmarks measure against the original per-block path."""
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF


def checksum(data) -> int:
    """End-to-end extent checksum (DAOS-style). Fletcher-64 wide checksum —
    the port's fletcher kernel (`kernels/fletcher`) is the card-side
    equivalent (bit-identical packing), so device-direct placement can
    re-verify on the card."""
    return fletcher64(data)
