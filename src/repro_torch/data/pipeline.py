"""Training data pipeline over the ROS2 client.

This is where the paper's data path meets the training framework: token
shards live as DFS files in the object store; each data-parallel rank
streams its sample assignment through the RDMA data plane (optionally from
the DPU-offloaded client), with

  * background prefetch (bounded queue; overlap storage I/O with compute),
  * hedged reads for straggler mitigation: `hedge_timeout_s` arms EXTENT-
    level hedging inside the engine's `_read_extent` — a replica read
    exceeding the budget races the second replica's target and the first
    completion wins (the 3FS/loader trick, moved down from whole-op
    duplication so only the one slow extent pays a duplicate read, and
    `hedges_won` counts at extent granularity). Clients without engine
    support fall back to the old whole-op duplication,
  * deterministic epoch shuffling shared by all ranks (seeded permutation,
    disjoint per-rank slices),
  * elastic resharding: when the data-parallel world grows/shrinks, the
    assignment is recomputed from the next step boundary with full
    coverage and no duplication,
  * stall accounting (time `next()` blocks) -> the ingest benchmark's
    stall fraction.

Sample i covers token range [i*(seq+1), (i+1)*(seq+1)); reads spanning
shard-file boundaries are split across files.
"""
from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.core.faults import DEFAULT_TIMEOUTS, Timeouts, note_recovery

TOKEN_DTYPE = np.int32
TOKEN_BYTES = 4
META_FILE = "meta.json"


# ---------------------------------------------------------------------------
# Shard writing (dataset preparation)


def write_token_shards(client, root: str, tokens: np.ndarray,
                       shard_tokens: int = 1 << 20) -> Dict:
    """Write a token stream as DFS shard files + a meta.json manifest."""
    tokens = np.ascontiguousarray(tokens, TOKEN_DTYPE)
    client.mkdir(root)
    n_shards = (tokens.size + shard_tokens - 1) // shard_tokens
    for s in range(n_shards):
        chunk = tokens[s * shard_tokens:(s + 1) * shard_tokens]
        fd = client.open(f"{root}/shard-{s:05d}", create=True)
        client.pwrite(fd, chunk.tobytes(), 0)
    meta = {"total_tokens": int(tokens.size),
            "shard_tokens": int(shard_tokens),
            "n_shards": int(n_shards), "dtype": "int32"}
    fd = client.open(f"{root}/{META_FILE}", create=True)
    client.pwrite(fd, json.dumps(meta).encode(), 0)
    return meta


def read_meta(client, root: str) -> Dict:
    fd = client.open(f"{root}/{META_FILE}")
    size = client.dfs.stat(f"{root}/{META_FILE}")["size"]
    return json.loads(client.pread(fd, size, 0).decode())


# ---------------------------------------------------------------------------
# Assignment: deterministic shuffle, disjoint rank slices, elastic


@dataclass(frozen=True)
class Assignment:
    """Which global sample indices rank r reads at step t of an epoch."""
    n_samples: int
    global_batch: int
    dp_rank: int
    dp_size: int
    seed: int
    epoch: int

    def steps_per_epoch(self) -> int:
        return self.n_samples // self.global_batch

    def local_batch(self) -> int:
        assert self.global_batch % self.dp_size == 0, \
            (self.global_batch, self.dp_size)
        return self.global_batch // self.dp_size

    def perm(self) -> np.ndarray:
        return np.random.default_rng(
            (self.seed, self.epoch)).permutation(self.n_samples)

    def samples_for_step(self, step: int) -> np.ndarray:
        b, lb = self.global_batch, self.local_batch()
        sl = self.perm()[step * b:(step + 1) * b]
        return sl[self.dp_rank * lb:(self.dp_rank + 1) * lb]


# ---------------------------------------------------------------------------
# Loader


class ROS2TokenLoader:
    def __init__(self, client, root: str, *, global_batch: int, seq_len: int,
                 dp_rank: int = 0, dp_size: int = 1, seed: int = 0,
                 prefetch: int = 2, hedge_timeout_s: Optional[float] = None,
                 read_delay_hook=None, io_depth: int = 8,
                 timeouts: Timeouts = DEFAULT_TIMEOUTS):
        self.client = client
        # one policy object for every loader wait (retry backoff, queue
        # polls, batch deadline, producer join) — same discipline as the
        # storage stack's data-path deadlines
        self.timeouts = timeouts
        self.root = root
        self.meta = read_meta(client, root)
        self.seq_len = seq_len
        self.sample_tokens = seq_len + 1
        self.n_samples = self.meta["total_tokens"] // self.sample_tokens
        self.global_batch = global_batch
        self.seed = seed
        self.epoch = 0
        self.step_in_epoch = 0
        self.asg = Assignment(self.n_samples, global_batch, dp_rank,
                              dp_size, seed, 0)
        self._gen = 0                 # bumped on reshard; stale batches drop
        self._fds = {
            s: client.open(f"{root}/shard-{s:05d}")
            for s in range(self.meta["n_shards"])}
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._reshard_lock = threading.Lock()
        # submit/reap depth: with a submit-capable client the producer
        # keeps up to io_depth preads in flight as completion handles
        # (reaped in submit order) instead of a thread-per-op pool
        self.io_depth = max(1, int(io_depth))
        # LAZY whole-op hedge pool: only the fallback hedging path (no
        # engine support) ever builds threads now
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        self.hedge_timeout_s = hedge_timeout_s
        self.read_delay_hook = read_delay_hook    # tests: inject stragglers
        # extent-level hedging: hand the budget to the ENGINE (it races
        # the second replica inside _read_extent) instead of duplicating
        # whole pread ops up here; the whole-op fallback stays for clients
        # without engine support
        self._engine_hedging = False
        self._hedge_base = (0, 0)
        if hedge_timeout_s is not None \
                and hasattr(client, "configure_hedged_reads"):
            client.configure_hedged_reads(hedge_timeout_s)
            self._engine_hedging = True
            self._hedge_base = self._engine_hedges()
        # metrics
        self.stall_s = 0.0
        self.read_s = 0.0
        self.bytes_read = 0
        self._local_hedges_issued = 0             # whole-op fallback only
        self._local_hedges_won = 0
        self.batches_produced = 0
        self.read_retries = 0
        self.last_error = ""
        self.failed = False
        self._thread = threading.Thread(target=self._producer,
                                        name="loader-producer", daemon=True)
        self._thread.start()

    MAX_READ_RETRIES = 5

    def _get_pool(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=4, thread_name_prefix="ros2-loader")
            return self._pool

    # -- byte-level read, possibly spanning shards, possibly hedged ---------
    def _span_reads(self, byte_off: int,
                    size: int) -> List[Tuple[int, int, int]]:
        """[(shard, shard_off, len)] covering the span (may cross shard
        files)."""
        st = self.meta["shard_tokens"] * TOKEN_BYTES
        out = []
        pos = 0
        while pos < size:
            shard = (byte_off + pos) // st
            so = (byte_off + pos) - shard * st
            ln = min(st - so, size - pos)
            out.append((shard, so, ln))
            pos += ln
        return out

    def _read_span(self, byte_off: int, size: int) -> bytes:
        out = bytearray(size)
        pos = 0
        for shard, so, ln in self._span_reads(byte_off, size):
            out[pos:pos + ln] = self._read_one(shard, so, ln)
            pos += ln
        return bytes(out)

    def _engine_hedges(self) -> tuple:
        """(hedges_issued, hedges_won) from the engine's merged counters
        (fleet-wide when the client routes a multi-target cluster)."""
        try:
            eng = self.client.io.data_path_counters()["engine"]
            return (int(eng.get("hedges_issued", 0)),
                    int(eng.get("hedges_won", 0)))
        # lint: allow(broad-except): a gauge read over another
        # subsystem's counter dict — any shape drift or closed client
        # reads as "no engine hedges yet" (0, 0); failing the data path
        # over a metrics peek would invert the dependency
        except Exception:
            return 0, 0

    @property
    def hedges_issued(self) -> int:
        return self._local_hedges_issued \
            + self._engine_hedges()[0] - self._hedge_base[0]

    @property
    def hedges_won(self) -> int:
        return self._local_hedges_won \
            + self._engine_hedges()[1] - self._hedge_base[1]

    def _read_one(self, shard: int, off: int, ln: int) -> bytes:
        def attempt(tag: int) -> bytes:
            if self.read_delay_hook is not None:
                self.read_delay_hook(shard, off, tag)
            return self.client.pread(self._fds[shard], ln, off)

        if self.hedge_timeout_s is None or self._engine_hedging:
            # straggler mitigation (when armed) happens INSIDE the engine,
            # at extent granularity — one plain pread from here
            return attempt(0)
        # whole-op fallback for clients without engine hedging: duplicate
        # the entire read against the replicated store; first wins
        pool = self._get_pool()
        primary = pool.submit(attempt, 0)
        done, _ = wait([primary], timeout=self.hedge_timeout_s,
                       return_when=FIRST_COMPLETED)
        if done:
            return primary.result()
        self._local_hedges_issued += 1
        backup = pool.submit(attempt, 1)
        done, _ = wait([primary, backup], return_when=FIRST_COMPLETED)
        winner = done.pop()
        if winner is backup:
            self._local_hedges_won += 1
        return winner.result()

    def _fetch_sample(self, idx: int) -> np.ndarray:
        off = idx * self.sample_tokens * TOKEN_BYTES
        size = self.sample_tokens * TOKEN_BYTES
        t0 = time.monotonic()
        raw = self._read_span(off, size)
        self.read_s += time.monotonic() - t0
        self.bytes_read += size
        return np.frombuffer(raw, TOKEN_DTYPE)

    # -- step fetch: io_depth submit/reap when the client supports it -------
    def _submit_capable(self) -> bool:
        """Handle-based fetch preconditions: a submit-capable client, no
        per-read test hook (its per-attempt semantics belong to the
        blocking path), and hedging — if armed — running inside the
        engine (extent-level), not as whole-op duplication."""
        return (hasattr(self.client, "submit_pread")
                and self.read_delay_hook is None
                and (self.hedge_timeout_s is None or self._engine_hedging))

    def _fetch_step(self, idxs) -> np.ndarray:
        """Fetch one step's samples. With a submit-capable client, every
        (sample, shard-segment) read is submitted as a completion handle
        with up to io_depth in flight — the deep-queue dispatch that
        replaces the old one-blocking-read-at-a-time producer — and
        reaped in submit order, so assembly (and therefore the batch) is
        deterministic. Otherwise the blocking per-sample path runs
        unchanged."""
        if self.io_depth <= 1 or not self._submit_capable():
            return np.stack([self._fetch_sample(int(i)) for i in idxs])
        size = self.sample_tokens * TOKEN_BYTES
        t0 = time.monotonic()
        bufs = [bytearray(size) for _ in idxs]
        plan = []                     # (sample_i, buf_off, shard, so, ln)
        for si, i in enumerate(idxs):
            pos = 0
            for shard, so, ln in self._span_reads(int(i) * size, size):
                plan.append((si, pos, shard, so, ln))
                pos += ln
        window: List[Tuple[int, int, int, object]] = []
        try:
            for si, pos, shard, so, ln in plan:
                h = self.client.submit_pread(self._fds[shard], ln, so)
                window.append((si, pos, ln, h))
                if len(window) >= self.io_depth:
                    self._reap_read(bufs, window.pop(0))
            while window:
                self._reap_read(bufs, window.pop(0))
        finally:
            for _si, _pos, _ln, h in window:   # error exit: cancel the
                h.cancel()                     # never-dispatched tail
        self.read_s += time.monotonic() - t0
        self.bytes_read += size * len(idxs)
        return np.stack([np.frombuffer(bytes(b), TOKEN_DTYPE)
                         for b in bufs])

    def _reap_read(self, bufs: List[bytearray], rd) -> None:
        si, pos, ln, h = rd
        bufs[si][pos:pos + ln] = h.wait()

    # -- producer thread ------------------------------------------------------
    def _producer(self) -> None:
        while not self._stop.is_set():
            with self._reshard_lock:
                asg, step, gen = self.asg, self.step_in_epoch, self._gen
                if step >= asg.steps_per_epoch():
                    self.epoch += 1
                    self.step_in_epoch = 0
                    self.asg = Assignment(
                        self.n_samples, self.global_batch, asg.dp_rank,
                        asg.dp_size, self.seed, self.epoch)
                    continue
                self.step_in_epoch += 1
            idxs = asg.samples_for_step(step)
            batch = None
            for attempt in range(self.MAX_READ_RETRIES):
                try:
                    arr = self._fetch_step(idxs)
                    batch = {"tokens": arr[:, :-1].astype(TOKEN_DTYPE),
                             "labels": arr[:, 1:].astype(TOKEN_DTYPE)}
                    if attempt:      # stall recovered: ledger the retry
                        note_recovery(getattr(self.client, "faults", None),
                                      "pipeline.read_retry")
                    break
                # lint: allow(broad-except): a COUNTED recovery, not a
                # swallow — the retry is bounded (MAX_READ_RETRIES), every
                # attempt is recorded in read_retries/last_error, success
                # after a retry ledgers pipeline.read_retry, and
                # exhaustion surfaces to the consumer via self.failed
                except Exception as e:
                    self.read_retries += 1
                    self.last_error = repr(e)
                    time.sleep(self.timeouts.backoff(attempt + 2,
                                                     salt=step))
            if batch is None:
                # persistent failure — surface to the consumer and stop
                self.failed = True
                return
            while not self._stop.is_set():
                try:
                    self._q.put((gen, step, batch),
                                timeout=self.timeouts.poll_interval_s)
                    break
                except queue.Full:
                    continue

    # -- consumer API ---------------------------------------------------------
    def next_batch(self, timeout: Optional[float] = None
                   ) -> Dict[str, np.ndarray]:
        if timeout is None:
            timeout = self.timeouts.op_deadline_s
        t0 = time.monotonic()
        deadline = t0 + timeout
        while True:
            if self.failed:
                raise IOError(f"loader producer failed after "
                              f"{self.read_retries} retries: "
                              f"{self.last_error}")
            try:
                gen, step, batch = self._q.get(
                    timeout=self.timeouts.poll_interval_s)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise
                continue
            if gen == self._gen:          # drop batches from pre-reshard gen
                break
        self.stall_s += time.monotonic() - t0
        self.batches_produced += 1
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- elastic resharding ----------------------------------------------------
    def reshard(self, dp_rank: int, dp_size: int) -> None:
        """Hosts joined/left: recompute this rank's assignment from the next
        step. Global batch is unchanged; coverage stays exact because every
        rank derives the same seeded permutation."""
        with self._reshard_lock:
            a = self.asg
            self.asg = Assignment(a.n_samples, a.global_batch, dp_rank,
                                  dp_size, a.seed, a.epoch)
            self._gen += 1
        # drop batches already prefetched under the old assignment (any
        # batch still in flight carries a stale generation tag and is
        # discarded by next_batch)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def metrics(self) -> Dict[str, float]:
        return {"stall_s": self.stall_s, "read_s": self.read_s,
                "bytes_read": float(self.bytes_read),
                "hedges_issued": float(self.hedges_issued),
                "hedges_won": float(self.hedges_won),
                "batches": float(self.batches_produced)}

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self.timeouts.thread_join_s)
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=False)


def coverage_check(n_samples: int, global_batch: int, dp_size: int,
                   seed: int = 0, epoch: int = 0) -> bool:
    """All ranks together read each step's global batch exactly once."""
    per_step: List[np.ndarray] = []
    asgs = [Assignment(n_samples, global_batch, r, dp_size, seed, epoch)
            for r in range(dp_size)]
    steps = asgs[0].steps_per_epoch()
    seen = []
    for t in range(steps):
        got = np.concatenate([a.samples_for_step(t) for a in asgs])
        if len(np.unique(got)) != global_batch:
            return False
        seen.append(got)
    allseen = np.concatenate(seen)
    return len(np.unique(allseen)) == steps * global_batch
