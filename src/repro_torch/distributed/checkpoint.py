"""Asynchronous checkpointing through the ROS2 object store, the
counterpart of `repro/distributed/checkpoint.py`.

Mirrors the paper's §2.2 workload (iii): "asynchronous checkpointing
during training" — the train loop snapshots device state to host, hands it
to a background writer, and keeps stepping while the bytes stream through
the RDMA data plane into replicated DAOS objects.

Crash consistency: leaves are written first, then manifest.json, then an
empty COMMIT marker. restore() only considers steps whose COMMIT exists
and whose per-leaf CRCs verify — a writer killed mid-flight (failure
injection in tests) leaves a garbage step directory that is simply
ignored and later garbage-collected.

Layout under <root>/step-<N>/, the reference's byte for byte:
    manifest.json   {step, leaves: [{name, shape, dtype, crc32, nbytes}]}
    COMMIT          (empty, written last)
    <leaf-name>     raw bytes per leaf (bfloat16 through a uint16 view)

A tree is nested dicts, NamedTuples (such as `AdamState`), lists and
tuples over tensors or arrays. Leaf names are built as
`jax.tree_util.keystr` builds them — dict keys in sorted order as
`['key']`, NamedTuple fields in field order as `.field`, sequence items as
`[i]` — and cleaned as the reference cleans them, so both packages read
each other's checkpoints.
"""
from __future__ import annotations

import json
import re
import threading
import zlib
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch

_STEP_RE = re.compile(r"^step-(\d+)$")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in jax.tree's order; None is no leaf."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _walk(tree[key], f"{path}[{key!r}]")
    elif _is_namedtuple(tree):
        for field in tree._fields:
            yield from _walk(getattr(tree, field), f"{path}.{field}")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _walk(item, f"{path}[{i}]")
    else:
        yield path, tree


def _unflatten(tree, leaves: Iterator[Any]):
    """`tree`'s structure with its leaves taken in order from `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {key: _unflatten(tree[key], leaves) for key in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves)
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(item, leaves) for item in tree)
    return next(leaves)


def _leaf_name(path: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", path).strip("_") or "leaf"


def _flatten_named(tree) -> List[Tuple[str, Any]]:
    out, seen = [], {}
    for path, leaf in _walk(tree):
        name = _leaf_name(path)
        n = seen.get(name, 0)
        seen[name] = n + 1
        out.append((f"{name}.{n}" if n else name, leaf))
    return out


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(host array of a copy of the leaf's bytes, its dtype name). A copy
    even on the CPU: the train step updates its params and moments in
    place while the writer thread still reads the snapshot."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_bytes(data: bytes, dtype: str) -> np.ndarray:
    if dtype == "bfloat16":
        import ml_dtypes              # what the reference's arrays use
        return np.frombuffer(data, dtype=ml_dtypes.bfloat16)
    return np.frombuffer(data, dtype=np.dtype(dtype))


class ROS2CheckpointManager:
    def __init__(self, client, root: str = "/ckpt", *, keep: int = 2,
                 asynchronous: bool = True):
        self.client = client
        self.root = root
        self.keep = keep
        self.asynchronous = asynchronous
        try:
            client.mkdir(root)
        except Exception:
            pass
        self._worker: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.saves = 0
        self.bytes_written = 0

    # -- save ------------------------------------------------------------------
    def save(self, step: int, tree) -> None:
        """Snapshot to host in the calling thread, then write
        asynchronously (double-buffered: joins the previous writer first so
        at most one save is in flight)."""
        self.wait()
        host = [(name, *_to_host(leaf)) for name, leaf in
                _flatten_named(tree)]
        if self.asynchronous:
            self._worker = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._worker.start()
        else:
            self._write(step, host)

    # checkpoint leaves stream in bounded chunks so the data plane
    # interleaves loader reads between them — a monolithic GB-scale pwrite
    # would hold the transport serialization long enough to starve
    # latency-sensitive readers
    WRITE_CHUNK = 8 << 20

    def _write(self, step: int,
               host: List[Tuple[str, np.ndarray, str]]) -> None:
        try:
            d = f"{self.root}/step-{step}"
            self.client.mkdir(d)
            leaves = []
            for name, arr, dtype in host:
                data = arr.tobytes()
                fd = self.client.open(f"{d}/{name}", create=True)
                for off in range(0, max(len(data), 1), self.WRITE_CHUNK):
                    self.client.pwrite(fd, data[off:off + self.WRITE_CHUNK],
                                       off)
                leaves.append({"name": name, "shape": list(arr.shape),
                               "dtype": dtype,
                               "crc32": zlib.crc32(data) & 0xFFFFFFFF,
                               "nbytes": len(data)})
                self.bytes_written += len(data)
            man = {"step": step, "leaves": leaves}
            fd = self.client.open(f"{d}/manifest.json", create=True)
            self.client.pwrite(fd, json.dumps(man).encode(), 0)
            fd = self.client.open(f"{d}/COMMIT", create=True)
            self.client.pwrite(fd, b"1", 0)
            self.saves += 1
            self._gc()
        except BaseException as e:   # surfaced on next wait()
            self._error = e

    def wait(self) -> None:
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # -- restore ----------------------------------------------------------------
    def _steps(self) -> List[int]:
        try:
            entries = self.client.dfs.readdir(self.root)
        except Exception:
            return []
        out = []
        for e in entries:
            m = _STEP_RE.match(e)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def committed_steps(self) -> List[int]:
        out = []
        for s in self._steps():
            try:
                self.client.dfs.stat(f"{self.root}/step-{s}/COMMIT")
                out.append(s)
            except Exception:
                continue
        return out

    def latest_step(self) -> Optional[int]:
        c = self.committed_steps()
        return c[-1] if c else None

    def restore(self, tree_like, step: Optional[int] = None):
        """Restore into the structure of `tree_like` (tensors or arrays).
        Returns (step, tree of numpy arrays) or (None, None)."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        d = f"{self.root}/step-{step}"
        fd = self.client.open(f"{d}/manifest.json")
        size = self.client.dfs.stat(f"{d}/manifest.json")["size"]
        man = json.loads(self.client.pread(fd, size, 0).decode())
        by_name = {l["name"]: l for l in man["leaves"]}
        leaves = []
        for name, _like in _flatten_named(tree_like):
            ent = by_name[name]
            fd = self.client.open(f"{d}/{name}")
            data = self.client.pread(fd, ent["nbytes"], 0)
            if (zlib.crc32(data) & 0xFFFFFFFF) != ent["crc32"]:
                raise IOError(f"checkpoint leaf {name} failed CRC")
            leaves.append(_from_bytes(data, ent["dtype"]).reshape(
                ent["shape"]))
        return step, _unflatten(tree_like, iter(leaves))

    # -- gc -------------------------------------------------------------------
    def _gc(self) -> None:
        commits = self.committed_steps()
        doomed = commits[:-self.keep] if self.keep else []
        # also drop uncommitted wreckage older than the newest commit
        latest = commits[-1] if commits else -1
        for s in self._steps():
            if s in doomed or (s not in commits and s < latest):
                self._rm_step(s)

    def _rm_step(self, s: int) -> None:
        d = f"{self.root}/step-{s}"
        try:
            for e in self.client.dfs.readdir(d):
                self.client.dfs.unlink(f"{d}/{e}")
            self.client.dfs.unlink(d)
        except Exception:
            pass
