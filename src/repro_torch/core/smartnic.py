"""SmartNIC (BlueField-3) offload runtime.

The DPU runs the entire DFS client stack on its Arm cores: the host only
posts submission-queue entries (doorbells) and polls completion-queue
entries — it never touches the data path (the paper's core design).

Functional model: a pool of worker threads ("Arm cores", 16 by default)
consumes SQEs from a bounded ring, executes DFS ops (including transport
and optional inline services: per-tenant encryption + checksum close to the
NIC), and posts CQEs. Host<->DPU interaction is only ring writes/reads.

SQEs carry whole descriptor lists where the op is vectored: the
`read_into_many` op ships [(fd, size, offset, dst_off), ...] in ONE SQE —
one doorbell, one completion for an entire batched device-direct placement
(DeviceDirectSink.read_tensors packs a ring slot per SQE this way). On a
multi-target client the handlers execute against the striping cluster
router, so one doorbell's op fans out to per-target data-plane sessions
on the Arm cores — the host still only rings once.
Background services (`start_housekeeping`) run near-NIC periodic work on
an Arm core: capability lease renewal and the idle-aware MediaScrubber's
pacing both ride it in dpu mode.
"""
from __future__ import annotations

import itertools
import queue
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.core.faults import DEFAULT_TIMEOUTS, OpTimeout, Timeouts

N_ARM_CORES = 16

GOLDEN32 = 0x9E3779B9
KEYSTREAM_PAGE = 64 * 1024          # bytes of stream cached per page
KEYSTREAM_CACHE_BYTES = 128 << 20   # default LRU capacity


@dataclass
class SQE:
    tag: int
    op: str                         # "read" | "write" | "open" | ...
    args: Dict[str, Any]


@dataclass
class CQE:
    tag: int
    ok: bool
    result: Any = None
    error: str = ""


@dataclass
class CryptoStats:
    keystream_bytes_generated: int = 0   # PRF work actually performed
    keystream_bytes_served: int = 0      # stream bytes consumed by applies
    cache_hits: int = 0                  # page-cache hits
    cache_misses: int = 0
    xor_bytes: int = 0                   # bytes XORed (fused or not)


def _as_u8(data) -> np.ndarray:
    """Zero-copy uint8 view of bytes / bytearray / memoryview / ndarray.
    No implicit materialization: contiguous buffers are wrapped in place;
    only a non-contiguous memoryview (rare) must be compacted."""
    if isinstance(data, np.ndarray):
        return data.view(np.uint8) if data.dtype != np.uint8 else data
    if isinstance(data, memoryview) and not data.contiguous:
        return np.asarray(data, dtype=np.uint8).reshape(-1)
    return np.frombuffer(data, np.uint8)


class InlineCrypto:
    """Counter-mode XOR keystream applied on the DPU data path.

    The PRF is the murmur3-finalizer over (u32 word counter + nonce) —
    bit-identical to the port's stream_cipher kernel
    (`kernels/stream_cipher`, `ref.keystream_u32`), so bytes encrypted
    inline by the DPU can be decrypted on the card by that kernel and vice
    versa.

    Keystream pages (KEYSTREAM_PAGE bytes of stream per (nonce, page)) are
    memoized in an LRU so steady-state re-reads of the same blocks pay zero
    PRF regeneration; `apply_into` fuses the XOR with the splice into the
    caller's buffer (one pass, no temporary). `cache_bytes=0` disables the
    cache (the sg path's regenerate-every-op behavior, kept for benchmarks)."""

    def __init__(self, key: int, cache_bytes: int = KEYSTREAM_CACHE_BYTES):
        # fold 64-bit keys into the u32 lane the kernel PRF uses (high half
        # mixed, never discarded: keys equal mod 2^32 stay distinct), and
        # guard the degenerate zero key AFTER folding
        key = int(key or GOLDEN32)
        self.key = np.uint32(((key & 0xFFFFFFFF) ^ self._fmix32(key >> 32))
                             or GOLDEN32)
        # a cache that cannot hold one page is a cache that stores nothing
        # but still pays full-page generation: treat it as disabled
        self.cache_bytes = int(cache_bytes) if cache_bytes >= KEYSTREAM_PAGE \
            else 0
        self._pages: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
        self._cache_lock = threading.Lock()
        self.stats = CryptoStats()

    # -- PRF ----------------------------------------------------------------
    @staticmethod
    def _fmix32(x: int) -> int:
        """Scalar murmur3 finalizer; fmix32(0) == 0, so nonces < 2^32 keep
        the plain key (bit-identical to the stream_cipher kernel)."""
        x &= 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x85EBCA6B) & 0xFFFFFFFF
        x ^= x >> 13
        x = (x * 0xC2B2AE35) & 0xFFFFFFFF
        x ^= x >> 16
        return x

    def _prf_words(self, first_word: int, n_words: int,
                   nonce: int) -> np.ndarray:
        """murmur3-finalizer keystream words [first_word, first_word+n).
        Nonce bits >= 32 are folded into the key (fmix32 of the high half)
        rather than discarded, so two streams whose nonces agree mod 2^32
        (e.g. oids 4096 apart) never share a keystream; the
        `kernels/stream_cipher` kernel decrypts such streams by receiving
        the same folded key."""
        key = self.key ^ np.uint32(self._fmix32(nonce >> 32))
        idx = np.arange(first_word, first_word + n_words, dtype=np.uint32)
        with np.errstate(over="ignore"):
            x = (idx + np.uint32(nonce & 0xFFFFFFFF)) * np.uint32(GOLDEN32) \
                + key
            x ^= x >> np.uint32(16)
            x *= np.uint32(0x85EBCA6B)
            x ^= x >> np.uint32(13)
            x *= np.uint32(0xC2B2AE35)
            x ^= x >> np.uint32(16)
        return x

    def _page(self, nonce: int, page: int) -> np.ndarray:
        """Keystream bytes [page*PAGE, (page+1)*PAGE) of the nonce's stream,
        served from the LRU when warm."""
        k = (int(nonce), page)
        with self._cache_lock:
            ks = self._pages.get(k)
            if ks is not None:
                self._pages.move_to_end(k)
                self.stats.cache_hits += 1
                return ks
            self.stats.cache_misses += 1
        words = KEYSTREAM_PAGE // 4
        ks = self._prf_words(page * words, words, nonce).view(np.uint8)
        with self._cache_lock:
            self.stats.keystream_bytes_generated += KEYSTREAM_PAGE
            if self.cache_bytes >= KEYSTREAM_PAGE:
                self._pages[k] = ks
                while len(self._pages) * KEYSTREAM_PAGE > self.cache_bytes:
                    self._pages.popitem(last=False)
        return ks

    def keystream(self, n: int, nonce: int, offset: int = 0) -> np.ndarray:
        """Keystream bytes [offset, offset+n) of the (nonce-scoped) stream."""
        if self.cache_bytes <= 0:
            # uncached: generate exactly the covering word span
            first = offset // 4
            words = (offset + n + 3) // 4 - first
            ks = self._prf_words(first, words, nonce).view(np.uint8)
            with self._cache_lock:
                self.stats.keystream_bytes_generated += 4 * words
            skip = offset - first * 4
            return ks[skip:skip + n]
        out = np.empty(n, np.uint8)
        pos = 0
        while pos < n:
            page, po = divmod(offset + pos, KEYSTREAM_PAGE)
            take = min(n - pos, KEYSTREAM_PAGE - po)
            out[pos:pos + take] = self._page(nonce, page)[po:po + take]
            pos += take
        return out

    # -- data-path entry points ---------------------------------------------
    def apply(self, data, nonce: int, offset: int = 0) -> np.ndarray:
        """XOR with the keystream at byte position `offset` of the (nonce-
        scoped) block stream, so partial-block reads decrypt with the same
        stream positions the write used. Accepts ndarray / bytes /
        memoryview without an implicit copy of the input."""
        src = _as_u8(data)
        out = np.empty(src.size, np.uint8)
        self.apply_into(out, src, nonce, offset)
        return out

    def apply_into(self, dst, src, nonce: int, offset: int = 0) -> int:
        """Fused XOR-while-splice: dst[i] = src[i] ^ ks[offset+i] in one
        pass, directly into the caller's buffer. `dst is src` (or a view of
        the same memory) performs the in-place transform the staging legs
        use — no temporary keystream-sized or data-sized allocation beyond
        the cached pages. Returns the byte count."""
        d = _as_u8(dst)
        s = _as_u8(src)
        n = s.size
        if self.cache_bytes <= 0:
            np.bitwise_xor(s, self.keystream(n, nonce, offset), out=d[:n])
        else:
            pos = 0
            while pos < n:
                page, po = divmod(offset + pos, KEYSTREAM_PAGE)
                take = min(n - pos, KEYSTREAM_PAGE - po)
                np.bitwise_xor(s[pos:pos + take],
                               self._page(nonce, page)[po:po + take],
                               out=d[pos:pos + take])
                pos += take
        with self._cache_lock:
            self.stats.keystream_bytes_served += n
            self.stats.xor_bytes += n
        return n


class DPURuntime:
    """Worker pool + SQ/CQ rings."""

    def __init__(self, n_cores: int = N_ARM_CORES, sq_depth: int = 1024,
                 timeouts: Timeouts = DEFAULT_TIMEOUTS):
        self.n_cores = n_cores
        self.timeouts = timeouts
        self.faults = None            # optional FaultInjector (core.faults)
        self.sq: "queue.Queue[Optional[SQE]]" = queue.Queue(sq_depth)
        self.cq: "queue.Queue[CQE]" = queue.Queue()
        self._tags = itertools.count(1)
        self._handlers: Dict[str, Callable[..., Any]] = {}
        self._workers = []
        self._started = False
        self.ops_processed = 0
        self.doorbells = 0            # host->NIC SQ crossings (MMIO rings)
        self._lock = threading.Lock()
        self._claimed: Dict[int, CQE] = {}
        self._claim_lock = threading.Lock()
        self._services: List[tuple] = []     # (thread, stop_event) pairs
        self.housekeeping_runs = 0

    def register(self, op: str, fn: Callable[..., Any]) -> None:
        self._handlers[op] = fn

    def start_housekeeping(self, name: str, fn: Callable[[], Any],
                           interval_s: float = 1.0) -> None:
        """Run `fn` periodically on a dedicated Arm-core service thread —
        the DPU-resident background work the paper's offload model keeps
        near the NIC (lease renewal, scrub pacing). Stopped by stop()."""
        stop = threading.Event()

        def loop():
            while not stop.wait(interval_s):
                try:
                    fn()
                # lint: allow(broad-except): a periodic housekeeping tick
                # (lease renewal, scrub pacing) must never kill the Arm
                # service thread — the next tick retries, and the real
                # failure surfaces at the op that needed the lease
                except Exception:
                    pass
                with self._lock:
                    self.housekeeping_runs += 1

        t = threading.Thread(target=loop, name=f"dpu-{name}", daemon=True)
        t.start()
        self._services.append((t, stop))

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for i in range(self.n_cores):
            t = threading.Thread(target=self._worker, name=f"arm{i}",
                                 daemon=True)
            t.start()
            self._workers.append(t)

    def _worker(self) -> None:
        while True:
            sqe = self.sq.get()
            if sqe is None:
                return
            try:
                fn = self._handlers[sqe.op]
                res = fn(**sqe.args)
                self.cq.put(CQE(sqe.tag, True, res))
            # lint: allow(broad-except): not a swallow — the worker
            # CONVERTS any handler failure into an error CQE, so the
            # initiator's wait_tag sees the typed message and the Arm
            # core survives to serve the next SQE (a dead worker would
            # hang every later doorbell)
            except Exception as e:
                self.cq.put(CQE(sqe.tag, False, None,
                                f"{type(e).__name__}: {e}"))
            with self._lock:
                self.ops_processed += 1

    # -- host-side API (doorbell + completion polling only) -----------------
    def submit(self, op: str, **args) -> int:
        if self.faults is not None:
            self.faults.fire(f"dpu.submit.{op}")
        tag = next(self._tags)
        self.sq.put(SQE(tag, op, args))
        self.doorbells += 1
        return tag

    def submit_many(self, ops) -> List[int]:
        """Post a batch of SQEs with ONE doorbell (one host<->NIC crossing
        for the whole batch — the Wei et al. batching that keeps off-path
        DPU submission cost amortized). `ops` is an iterable of
        (op, kwargs) pairs; returns the tags in order."""
        tags: List[int] = []
        for op, args in ops:
            tag = next(self._tags)
            tags.append(tag)
            self.sq.put(SQE(tag, op, dict(args)))
        if tags:
            self.doorbells += 1
        return tags

    def wait_all(self, tags, timeout: Optional[float] = None
                 ) -> Dict[int, CQE]:
        """Collect the completions for a batch of tags (single CQ drain
        loop; completions for other waiters are parked, as in wait_tag)."""
        import time as _time
        timeout = self.timeouts.dpu_wait_s if timeout is None else timeout
        tags = list(tags)
        start = _time.monotonic()
        deadline = start + timeout
        out: Dict[int, CQE] = {}
        for tag in tags:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                raise OpTimeout("dpu.wait_all", target=f"tag {tag}",
                                elapsed_s=_time.monotonic() - start,
                                detail=f"{len(out)}/{len(tags)} done")
            out[tag] = self.wait_tag(tag, timeout=remaining)
        return out

    def poll(self, timeout: Optional[float] = None) -> CQE:
        timeout = self.timeouts.dpu_tag_s if timeout is None else timeout
        return self.cq.get(timeout=timeout)

    def wait_tag(self, tag: int, timeout: Optional[float] = None) -> CQE:
        """Wait for a specific completion; safe for concurrent callers
        (completions claimed for other tags are parked for their owners)."""
        import time as _time
        timeout = self.timeouts.dpu_tag_s if timeout is None else timeout
        start = _time.monotonic()
        deadline = start + timeout
        while _time.monotonic() < deadline:
            with self._claim_lock:
                c = self._claimed.pop(tag, None)
                if c is not None:
                    return c
                try:
                    c = self.cq.get(timeout=self.timeouts.poll_interval_s)
                except queue.Empty:
                    continue
                if c.tag == tag:
                    return c
                self._claimed[c.tag] = c
        raise OpTimeout("dpu.wait_tag", target=f"tag {tag}",
                        elapsed_s=_time.monotonic() - start,
                        detail="no completion")

    def drain(self, n: int, timeout: Optional[float] = None
              ) -> Dict[int, CQE]:
        return {c.tag: c for c in (self.poll(timeout) for _ in range(n))}

    def stop(self) -> None:
        join_s = self.timeouts.thread_join_s
        for _t, ev in self._services:
            ev.set()
        for t, _ev in self._services:
            t.join(timeout=join_s)
        self._services.clear()
        for _ in self._workers:
            self.sq.put(None)
        for t in self._workers:
            t.join(timeout=join_s)
        self._workers.clear()
        self._started = False
