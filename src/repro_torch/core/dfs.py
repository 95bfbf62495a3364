"""DFS: POSIX-compatible file layer over the object store.

Files and directories map to DAOS objects; file data is striped into
aligned 1 MiB blocks (dkey = block index), directories are name->oid maps.
Metadata ops travel over the control plane; bulk data over the data plane.

The layer is cluster-transparent: on a multi-target client the I/O
adapter underneath is the striping _ClusterRouter and `DFSMeta` is bound
to the StorageCluster (whose pools/containers mirror the ObjectStore
surface), so files stripe across engine targets and metadata ops
(truncate punch, unlink reclaim) fan out fleet-wide — with ZERO changes
to anything in this file's API.

Control-path economy: DFSClient consults a leased MetadataCache
(metadata_cache.py) before spending a round-trip — a warm `open` costs
ZERO control RPCs — and holds a size delegation while a file is open:
`pwrite`/`pwritev` track the size locally and ONE piggybacked `set_size`
flushes it at `close`/`fsync` (an NFSv4-style write delegation), so the
canonical open→pwritev→close cycle costs at most two round-trips. Without
a cache (legacy clients) every op is a round-trip, as before.
"""
from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.object_store import (EC_DATA_AKEY, EC_STRIPE_BYTES, Container,
                                     ObjectStore, StorageError)

BLOCK = 1 << 20                    # 1 MiB DFS striping unit
AKEY = "data"

# EC cell addressing derives cell identity from extent offsets within this
# same striping unit and akey; the constants cannot drift apart silently.
assert BLOCK == EC_STRIPE_BYTES and AKEY == EC_DATA_AKEY

# RPC-envelope fields that must never leak into client-facing metadata
_TRANSPORT_KEYS = ("ok", "error", "lease_ttl_s")


def norm_path(path: str) -> str:
    if not path.startswith("/"):
        path = "/" + path
    return path.rstrip("/") or "/"


def _strip(r: Dict[str, Any]) -> Dict[str, Any]:
    """Drop transport-envelope fields from an RPC reply, leaving only
    metadata (the `stat` audit: returning the raw envelope leaked `ok`)."""
    return {k: v for k, v in r.items() if k not in _TRANSPORT_KEYS}


class DFSError(Exception):
    pass


class DFSMeta:
    """Server-side namespace service (bound to the control plane).

    `store` is an ObjectStore or — for a multi-target deployment — a
    StorageCluster, whose pools/containers present the same surface; the
    container handle below is then a ClusterContainer whose object punch/
    destroy ops fan out across every engine target."""

    def __init__(self, store: ObjectStore):
        self.store = store
        self._mounts: Dict[int, Container] = {}
        self._ids = itertools.count(1)
        self._oids = itertools.count(100)
        self._lock = threading.Lock()
        # path metadata: path -> {oid, is_dir, size}
        self._ns: Dict[str, Dict[str, Any]] = {"/": {"oid": 1, "is_dir": True,
                                                     "size": 0}}
        self.container: Optional[Container] = None

    def mount(self, pool: str, container: str) -> int:
        p = self.store.pools.get(pool) or self.store.create_pool(pool)
        c = p.containers.get(container) or p.create_container(container)
        with self._lock:
            mid = next(self._ids)
            self._mounts[mid] = c
            self.container = c
        return mid

    def _norm(self, path: str) -> str:
        return norm_path(path)

    def _parent(self, path: str) -> str:
        return path.rsplit("/", 1)[0] or "/"

    def lookup(self, path: str) -> Dict[str, Any]:
        path = self._norm(path)
        with self._lock:
            ent = self._ns.get(path)
        if ent is None:
            raise KeyError(f"ENOENT: {path}")
        return dict(ent, path=path)

    def create(self, path: str, is_dir: bool = False) -> Dict[str, Any]:
        path = self._norm(path)
        parent = self._parent(path)
        with self._lock:
            if parent not in self._ns or not self._ns[parent]["is_dir"]:
                raise KeyError(f"ENOTDIR: {parent}")
            if path in self._ns:
                return dict(self._ns[path], path=path, created=False)
            ent = {"oid": next(self._oids), "is_dir": is_dir, "size": 0}
            self._ns[path] = ent
        return dict(ent, path=path, created=True)

    def unlink(self, path: str) -> Dict[str, Any]:
        path = self._norm(path)
        with self._lock:
            if path not in self._ns:
                raise KeyError(f"ENOENT: {path}")
            if self._ns[path]["is_dir"] and any(
                    p.startswith(path + "/") for p in self._ns):
                raise ValueError(f"ENOTEMPTY: {path}")
            ent = self._ns.pop(path)
        # reclaim the backing object's extents NOW — before this fix the
        # namespace entry vanished but every extent stayed live forever.
        # (No open-handle grace in this model: unlink of an open file drops
        # the data immediately; subsequent reads see holes.)
        if not ent["is_dir"] and self.container is not None:
            self.container.destroy_object(ent["oid"])
        return {}

    def readdir(self, path: str) -> List[str]:
        path = self._norm(path)
        pre = path if path != "/" else ""
        with self._lock:
            return sorted(p[len(pre) + 1:] for p in self._ns
                          if p.startswith(pre + "/")
                          and "/" not in p[len(pre) + 1:])

    def stat(self, path: str) -> Dict[str, Any]:
        return self.lookup(path)

    def set_size(self, path: str, size: int) -> Dict[str, Any]:
        """Grow-only by design: concurrent writers race their set_size
        updates and a lagging small write must not shrink the file.
        Shrinking is an explicit, destructive operation — `truncate`."""
        path = self._norm(path)
        with self._lock:
            ent = self._ns.get(path)
            if ent is None:
                raise KeyError(f"ENOENT: {path}")
            ent["size"] = max(ent["size"], size)
        return dict(ent)

    def truncate(self, path: str, size: int) -> Dict[str, Any]:
        """Explicit truncation: set the size EXACTLY and punch now-out-of-
        range blocks from the backing object (whole blocks beyond the new
        EOF are freed; the boundary block is trimmed so a later re-grow
        reads zeros, not resurrected bytes). Before this existed,
        set_size's grow-only max() silently ignored every shrink."""
        path = self._norm(path)
        size = int(size)
        if size < 0:
            raise ValueError(f"EINVAL: negative size {size}")
        with self._lock:
            ent = self._ns.get(path)
            if ent is None:
                raise KeyError(f"ENOENT: {path}")
            if ent["is_dir"]:
                raise ValueError(f"EISDIR: {path}")
            ent["size"] = size
            oid = ent["oid"]
            snapshot = dict(ent)
        # Punch by what the backing object actually HOLDS, not by the
        # namespace size — under the client size delegation the recorded
        # size can lag the written extents, and those must die too. A
        # concurrent writer holding a delegation may legitimately re-extend
        # the file afterwards (same race POSIX allows).
        if self.container is not None:
            obj = self.container.object(oid)
            first_dead = -(-size // BLOCK)          # ceil: fully-dead blocks
            for dk in obj.dkeys(AKEY):
                if int(dk) >= first_dead:
                    obj.punch(dk, AKEY)
            if size % BLOCK:                         # trim the boundary block
                obj.punch_range(str(size // BLOCK), AKEY, size % BLOCK)
        return snapshot


@dataclass
class FileHandle:
    fd: int
    path: str
    oid: int


class DFSClient:
    """Client-side POSIX-like API. Lives on the host or on the DPU.

    Data flows: client buffer <-> (transport) <-> server staging region <->
    object store. Metadata flows over the control plane only — and with a
    MetadataCache attached, mostly doesn't flow at all: leased lookups make
    warm opens free, and size updates are delegated until close/fsync."""

    def __init__(self, control, io_service, session_id: int, cache=None):
        self.cp = control
        self.io = io_service            # server-side I/O engine adapter
        self.session_id = session_id
        self.cache = cache              # MetadataCache or None (legacy)
        self._fds = itertools.count(3)
        self._open: Dict[int, FileHandle] = {}
        # size delegation: path -> highest locally-known size not yet
        # flushed to the server (piggybacked set_size at close/fsync)
        self._pending_size: Dict[str, int] = {}
        self._meta_lock = threading.Lock()

    # -- plumbing ------------------------------------------------------------
    def _call(self, method: str, **kw) -> Dict[str, Any]:
        r = self.cp.rpc(method, session_id=self.session_id, **kw)
        if not r["ok"]:
            raise DFSError(r["error"])
        return r

    def _cache_put(self, r: Dict[str, Any]) -> None:
        if self.cache is not None and "path" in r:
            self.cache.put_meta(r["path"], _strip(r),
                                r.get("lease_ttl_s", 30.0))

    # -- namespace -----------------------------------------------------------
    def mount(self, pool: str = "pool0", container: str = "cont0") -> int:
        return self._call("mount", pool=pool, container=container)["mount_id"]

    def mkdir(self, path: str) -> None:
        self._cache_put(self._call("create", path=path, is_dir=True))

    def open(self, path: str, create: bool = False) -> int:
        path = norm_path(path)
        ent = None
        if self.cache is not None and not create:
            ent = self.cache.get_meta(path)       # warm open: 0 round-trips
        if ent is None:
            r = self._call("create" if create else "lookup", path=path)
            self._cache_put(r)
            ent = _strip(r)
        fd = next(self._fds)
        self._open[fd] = FileHandle(fd, ent["path"], ent["oid"])
        return fd

    def close(self, fd: int) -> None:
        h = self._open.pop(fd, None)
        if h is not None:
            self._flush_size(h.path)

    def _flush_size(self, path: Optional[str] = None) -> int:
        """Flush delegated sizes — ONE compound RPC carrying every pending
        set_size (all paths, or just `path`'s). Returns ops flushed."""
        with self._meta_lock:
            if path is None:
                todo = list(self._pending_size.items())
                self._pending_size.clear()
            else:
                sz = self._pending_size.pop(path, None)
                todo = [(path, sz)] if sz is not None else []
        flushed = 0
        while todo:
            ops = [{"method": "set_size", "args": {"path": p, "size": s}}
                   for p, s in todo]
            r = self._call("compound", ops=ops)
            done = r["completed"]
            flushed += done
            if done == len(ops):
                break
            err = r["results"][-1].get("error", "set_size failed")
            if "ENOENT" in err:
                # the file was unlinked underneath our delegation: its
                # size died with it — drop that op and flush the rest
                todo = todo[done + 1:]
                continue
            with self._meta_lock:     # genuine failure: re-queue the
                for p, s in todo[done:]:           # failed op + the tail
                    self._pending_size[p] = max(
                        self._pending_size.get(p, 0), s)
            raise DFSError(err)
        return flushed

    def flush_meta(self) -> int:
        """Flush ALL delegated size updates (client shutdown path)."""
        return self._flush_size(None)

    def unlink(self, path: str) -> None:
        path = norm_path(path)
        with self._meta_lock:
            self._pending_size.pop(path, None)   # size of a dead file
        self._call("unlink", path=path)
        if self.cache is not None:
            self.cache.invalidate(path)

    def truncate(self, path: str, size: int) -> Dict[str, Any]:
        """Explicit shrink-capable truncate (set_size stays grow-only)."""
        path = norm_path(path)
        with self._meta_lock:
            self._pending_size.pop(path, None)   # delegation superseded
        r = self._call("truncate", path=path, size=size)
        ent = _strip(r)
        if self.cache is not None:
            self.cache.put_meta(path, dict(ent, path=path),
                                r.get("lease_ttl_s", 30.0))
        return ent

    def readdir(self, path: str) -> List[str]:
        return self._call("readdir", path=path)["entries"]

    def stat(self, path: str) -> Dict[str, Any]:
        """Returns ONLY metadata ({oid, is_dir, size, path}) — transport
        fields are stripped (the raw-envelope leak this audits out), the
        leased cache serves warm stats, and our own unflushed size
        delegation overlays the server's (possibly lagging) size."""
        path = norm_path(path)
        ent = self.cache.get_meta(path) if self.cache is not None else None
        if ent is None:
            r = self._call("stat", path=path)
            self._cache_put(r)
            ent = _strip(r)
        with self._meta_lock:
            pending = self._pending_size.get(path)
        if pending is not None:
            ent = dict(ent, size=max(ent["size"], pending))
        return ent

    # -- data ------------------------------------------------------------
    def _note_size(self, path: str, size: int) -> None:
        """Record a write's high-water size under the delegation (0 RPCs);
        flushed by close/fsync. Without a cache, eagerly set_size (the
        pre-delegation behavior, one RPC per write op)."""
        if self.cache is None:
            self._call("set_size", path=path, size=size)
            return
        with self._meta_lock:
            if size > self._pending_size.get(path, -1):
                self._pending_size[path] = size
        self.cache.bump_size(path, size)   # keep our own lease coherent

    def _handle(self, fd: int) -> FileHandle:
        h = self._open.get(fd)
        if h is None:
            raise DFSError("EBADF")
        return h

    def _wrote(self, path: str, offset: int, written: int) -> int:
        """Post-write size delegation, composed INTO submitted write ops
        (`_then`) so it runs on the completing thread — a reap under the
        CQ lock must never do control RPCs."""
        self._note_size(path, offset + written)
        return written

    def pwrite(self, fd: int, data: bytes, offset: int) -> int:
        h = self._handle(fd)
        self.io.write(h.oid, offset, data)
        self._note_size(h.path, offset + len(data))
        return len(data)

    def pwritev(self, fd: int, buffers, offset: int) -> int:
        """Vectored write: the iovec is coalesced into scatter-gather
        transport ops by the server I/O adapter; file-size metadata rides
        the size delegation (0 RPCs here, ONE piggybacked set_size at
        close/fsync — or one eager RPC per writev without a cache).
        Blocking = submit + wait with inline execution (bit-identical;
        the op surface is defined ONCE, in `submit_pwritev`)."""
        return self.submit_pwritev(fd, buffers, offset,
                                   _inline=True).wait()

    def pread(self, fd: int, size: int, offset: int) -> bytes:
        return self.submit_pread(fd, size, offset, _inline=True).wait()

    def preadv(self, fd: int, sizes, offset: int) -> List[bytes]:
        """Vectored read: one gather op over the contiguous range. On the
        zero-copy path the SG descriptors scatter straight into the
        per-size result buffers (`readv_into`) — no contiguous
        intermediate `bytes` is materialized and re-sliced; the only
        remaining copy is the `bytes` materialization the return type
        demands. Falls back to the contiguous blob+slice path when the
        I/O adapter lacks vectored fill (legacy / sg mode).
        Blocking = submit + wait (op surface defined in `submit_preadv`)."""
        return self.submit_preadv(fd, sizes, offset, _inline=True).wait()

    # -- async submit/reap -----------------------------------------------
    def submit_pwritev(self, fd: int, buffers, offset: int,
                       timeout: Optional[float] = None,
                       _inline: bool = False):
        """Queue a vectored write; the handle's wait() yields the byte
        count. The size delegation lands when the WRITE completes (not at
        reap), so an abandoned handle still leaves metadata coherent."""
        h = self._handle(fd)
        return self.io.submit_writev(
            h.oid, offset, buffers, timeout=timeout, _inline=_inline,
            _then=lambda n, p=h.path, o=offset: self._wrote(p, o, n))

    def submit_pread(self, fd: int, size: int, offset: int,
                     timeout: Optional[float] = None,
                     _inline: bool = False):
        """Queue a read; the handle's wait() yields bytes."""
        h = self._handle(fd)
        return self.io.submit_read(h.oid, offset, size, timeout=timeout,
                                   _inline=_inline)

    def submit_preadv(self, fd: int, sizes, offset: int,
                      timeout: Optional[float] = None,
                      _inline: bool = False):
        """Queue a vectored read; the handle's wait() yields the per-size
        list of bytes. Result assembly (`tobytes` / blob slicing) is
        composed into the op via `_then` — it runs on the completing
        thread, never under the CQ lock."""
        h = self._handle(fd)
        sizes = [int(s) for s in sizes]
        if getattr(self.io, "supports_readv_into", False):
            bufs = [np.empty(s, np.uint8) for s in sizes]
            return self.io.submit_readv_into(
                h.oid, offset, bufs, timeout=timeout, _inline=_inline,
                _then=lambda _n, bs=bufs: [b.tobytes() for b in bs])

        def slice_out(blob: bytes) -> List[bytes]:
            out, pos = [], 0
            for s in sizes:
                out.append(blob[pos:pos + s])
                pos += s
            return out
        return self.io.submit_read(h.oid, offset, sum(sizes),
                                   timeout=timeout, _inline=_inline,
                                   _then=slice_out)

    def pread_into(self, fd: int, size: int, offset: int,
                   dst_mr, dst_off: int = 0) -> int:
        """Zero-copy read into a pre-registered memory region."""
        h = self._handle(fd)
        return self.io.read_into(h.oid, offset, size, dst_mr, dst_off)

    def pread_into_many(self, descs, dst_mr,
                        io_depth: Optional[int] = None) -> int:
        """Vectored zero-copy read: a descriptor list — [(fd, size,
        offset, dst_off)] — landing N file ranges (possibly from N
        different files) in one registered region. On the DPU this whole
        list arrives in a single SQE; each range is its own direct-splice
        placement. With a submit-capable adapter, up to `io_depth` ranges
        stay in flight as completion handles (default: the adapter's own
        io_depth) instead of one blocking read at a time; whichever
        completion settles FIRST is reaped first (`cq.wait_any`), so one
        slow range never head-of-line blocks the window the way
        submit-order reaping did. Returns total bytes read."""
        depth = io_depth if io_depth is not None \
            else getattr(self.io, "io_depth", 1)
        if depth <= 1 or not hasattr(self.io, "submit_read_into"):
            total = 0
            for fd, size, offset, dst_off in descs:
                h = self._handle(fd)
                total += self.io.read_into(h.oid, offset, size, dst_mr,
                                           dst_off)
            return total
        cq = getattr(self.io, "cq", None)
        total = 0
        window: List[Any] = []

        def reap_some() -> int:
            # out-of-submission-order reap when the adapter exposes its
            # CQ; FIFO head otherwise (every settled handle retires, so
            # the window never re-waits a completed op)
            done = cq.wait_any(window) if cq is not None else [window[0]]
            got = 0
            for d in done:
                window.remove(d)
                got += d.wait()
            return got

        try:
            for fd, size, offset, dst_off in descs:
                h = self._handle(fd)
                window.append(self.io.submit_read_into(
                    h.oid, offset, size, dst_mr, dst_off))
                if len(window) >= depth:
                    total += reap_some()
            while window:
                total += reap_some()
        finally:
            for w in window:    # error exit: never-dispatched handles die
                w.cancel()      # here; running ones drain in background
        return total

    def fsync(self, fd: int) -> None:
        """Data is durable at extent write; fsync flushes the METADATA
        delegation (the deferred set_size) so other sessions observe the
        file's true size."""
        h = self._open.get(fd)
        if h is not None:
            self._flush_size(h.path)


def split_blocks(offset: int, size: int) -> List[Tuple[int, int, int]]:
    """(block_idx, in-block offset, length) covering [offset, offset+size)."""
    out = []
    pos = offset
    end = offset + size
    while pos < end:
        b = pos // BLOCK
        bo = pos - b * BLOCK
        ln = min(BLOCK - bo, end - pos)
        out.append((b, bo, ln))
        pos += ln
    return out
