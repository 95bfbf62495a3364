"""Device-direct placement: the GPUDirect-RDMA analogue, into GPU memory.

The paper (§3.5) outlines optional GPU placement: the application registers
GPU buffers, the control plane conveys the descriptors (addresses, sizes,
rkeys) to the DPU/server, and on reads the storage server RDMA-writes
straight into GPU memory — same control/data-plane split, no DAOS engine
changes.

CUDA adaptation: the minimal-copy path is a *pinned, registered host ring*
the server places into DIRECTLY — `place_sg` validates the ring's
write-scoped rkey and the engine scatters the verified extent overlay
straight into the ring slots (the server-initiated "NIC DMA"; there is no
staging bounce anywhere on this path) — followed by one asynchronous
pinned-host -> device copy per slot on PyTorch's current stream. The ring
is a pinned `torch.uint8` tensor whose `.numpy()` view is the registered
region buffer, so the server splices into the very pages the copy engine
reads. On the CPU (`device="cpu"`) the ring is ordinary memory and the
"device" copy is a host copy.

Two placement shapes:

  * `read_tensor`: one tensor, one slot, one device copy — the
    latency-sensitive single-fetch.
  * `read_tensors`: BATCHED placement for LLM ingest (weight shards,
    token batches). Tensors are packed back-to-back into ring slots; each
    slot costs one vectored splice batch (`pread_into_many` — a single
    DPU doorbell in dpu mode) and ONE device copy for the whole packed
    slot instead of one per tensor, with per-tensor tensors carved on the
    device as dtype views. The ring is multi-buffered: a CUDA event marks
    each slot's copy, and only the next user of that slot waits on it, so
    while slot k's host->device copy is in flight, slot k+1's splice
    proceeds.

The ring registration is persistent: registered once at construction, its
placement rkey granted once PER PLACING SESSION and served from the NIC
translation cache for every subsequent read — on a multi-target client
the sink rides the cluster router unchanged: each engine target's session
grants its own capability on the shared ring, block ranges stripe across
targets, and `close()` retires the capability on every session. The capability leg is faithful: a revoked or
cross-tenant destination rkey cannot receive a direct splice (tests assert
it), and `close()` revokes the capability with the registration so a stale
NIC cache entry can never land bytes in recycled memory. The sink rides
the owning client's session — it issues NO control RPCs of its own
(constructing one used to leak a second, never-disconnected session)."""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _torch_dtype(np_dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


def _carve(packed: torch.Tensor, start: int, shape: Tuple[int, ...],
           np_dtype: np.dtype) -> torch.Tensor:
    """One tensor of a packed slot, carved out of its on-device uint8
    buffer as a dtype view (no copy). Tensors are packed back to back at
    any byte offset; `Tensor.view(dtype)` refuses a start that is not a
    multiple of the element size, so such a tensor alone takes one
    device-side copy to a fresh, aligned buffer first."""
    nbytes = int(np.prod(shape)) * np_dtype.itemsize
    seg = packed[start:start + nbytes]
    if start % np_dtype.itemsize:
        seg = seg.clone()
    return seg.view(_torch_dtype(np_dtype)).view(shape)


@dataclass
class DirectStats:
    reads: int = 0
    bytes: int = 0
    device_puts: int = 0
    batches: int = 0               # packed slots shipped by read_tensors


class DeviceDirectSink:
    """A ring of registered slots the data plane lands tensors in."""

    def __init__(self, client, slot_bytes: int, n_slots: int = 4, *,
                 device: DeviceLike = None):
        self.client = client
        self.slot_bytes = int(slot_bytes)
        self.n_slots = int(n_slots)
        # the client's device (the CUDA card unless it was asked for the
        # CPU) unless the caller names another
        self.device = client.device if device is None \
            else resolve_device(device)
        # persistent registration: one region, one (cached) placement
        # rkey; the region's buffer is the numpy view of a pinned tensor,
        # so the server splices straight into DMA-able pages
        self._host = torch.zeros(self.slot_bytes * self.n_slots,
                                 dtype=torch.uint8,
                                 pin_memory=self.device.type == "cuda")
        self.ring = client.register_region(self._host.numpy())
        # the sink rides the client's established session/capability path;
        # a raw `connect` here would leak an undisconnected second session
        # and bypass the compound/MetadataCache accounting
        self._sid = client.session_id
        self.stats = DirectStats()
        self._free = list(range(self.n_slots))
        self._cv = threading.Condition()
        # slot -> CUDA event of the device copy that still sources from
        # it; the wait happens at slot REUSE (in _acquire), so up to
        # n_slots placements + transfers stay in flight at once
        self._inflight: dict = {}
        self._closed = False

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        """Tear down the sink: revoke the placement capability and drop
        the ring registration (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self.client.io.drop_dst_rkey(self.ring)
        self.client.client_registry.deregister(self.ring)

    def __enter__(self) -> "DeviceDirectSink":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- slot lifecycle ------------------------------------------------------
    def _acquire(self) -> int:
        with self._cv:
            while not self._free:
                self._cv.wait()
            slot = self._free.pop()
            pending = self._inflight.pop(slot, None)
        if pending is not None:
            # the slot's previous copy must have finished before its ring
            # memory can be refilled (the DMA source is still live)
            pending.synchronize()
        return slot

    def _release(self, slot: int) -> None:
        with self._cv:
            self._free.append(slot)
            self._cv.notify()

    # -- the device-direct read ----------------------------------------------
    def read_tensor(self, fd: int, offset: int, shape: Tuple[int, ...],
                    dtype, *, device: DeviceLike = None) -> torch.Tensor:
        """Read a tensor's bytes from DFS straight into a ring slot, then a
        single device transfer (to the sink's device unless `device` names
        another). Raises if the tensor exceeds slot size."""
        np_dtype = np.dtype(dtype)
        size = int(np.prod(shape)) * np_dtype.itemsize
        if size > self.slot_bytes:
            raise ValueError(f"tensor {size}B exceeds slot {self.slot_bytes}B")
        slot = self._acquire()
        try:
            base = slot * self.slot_bytes
            self.client.pread_into(fd, size, offset, self.ring, base)
            dev = self.device if device is None else resolve_device(device)
            # pinned-host -> device DMA into a fresh (aligned) buffer
            arr = _carve(self._host[base:base + size].to(
                dev, non_blocking=True, copy=True), 0, tuple(shape), np_dtype)
            _wait(dev)
            self.stats.reads += 1
            self.stats.bytes += size
            self.stats.device_puts += 1
            return arr
        finally:
            self._release(slot)

    # -- batched placement ----------------------------------------------------
    def read_tensors(self, reqs: Sequence[Tuple[int, int, Tuple, object]],
                     *, device: DeviceLike = None) -> List[torch.Tensor]:
        """Batched device-direct placement: `reqs` is [(fd, offset, shape,
        dtype), ...]. Tensors are packed back-to-back into ring slots; per
        slot this costs ONE vectored splice batch (`pread_into_many` — a
        single DPU doorbell in dpu mode) and ONE host->device copy, with
        per-tensor tensors carved on the device as dtype views. Multi-
        buffered: slot k+1's splice overlaps slot k's host->device copy; a
        slot is only reused after its copy's CUDA event completed (so the
        DMA source is never overwritten in flight). Tensors land on the
        sink's device unless `device` names another; the tensors of one
        slot are views of one device buffer. Returns tensors in request
        order."""
        parsed = [(fd, off, tuple(shape), np.dtype(dtype))
                  for fd, off, shape, dtype in reqs]
        for _fd, _off, shape, np_dtype in parsed:
            size = int(np.prod(shape)) * np_dtype.itemsize
            if size > self.slot_bytes:
                raise ValueError(
                    f"tensor {size}B exceeds slot {self.slot_bytes}B")
        dev = self.device if device is None else resolve_device(device)
        out: List[Optional[torch.Tensor]] = [None] * len(parsed)
        i = 0
        while i < len(parsed):
            # greedy pack: as many consecutive tensors as fit in one slot
            pack, used = [], 0
            while i < len(parsed):
                fd, off, shape, np_dtype = parsed[i]
                size = int(np.prod(shape)) * np_dtype.itemsize
                if used + size > self.slot_bytes:
                    break
                pack.append((i, fd, off, shape, np_dtype, used, size))
                used += size
                i += 1
            slot = self._acquire()          # blocks iff the slot's previous
            try:                            # tensors are still in flight
                base = slot * self.slot_bytes
                self.client.pread_into_many(
                    [(fd, size, off, base + pos)
                     for _ix, fd, off, _sh, _dt, pos, size in pack],
                    self.ring)
                packed = self._host[base:base + used].to(
                    dev, non_blocking=True, copy=True)
                done = None
                if dev.type == "cuda":
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(dev))
                for ix, _fd, _off, shape, np_dtype, pos, _size in pack:
                    out[ix] = _carve(packed, pos, shape, np_dtype)
                self.stats.device_puts += 1
                self.stats.batches += 1
                self.stats.reads += len(pack)
                self.stats.bytes += used
                # hand the slot back immediately; the NEXT user of this
                # slot blocks on its copy's event (in _acquire) before
                # refilling it, so up to n_slots pipelines overlap
                if done is not None:
                    with self._cv:
                        self._inflight[slot] = done
            finally:
                self._release(slot)
        # the returned batch is fully materialized (callers may mutate or
        # re-read the files immediately)
        _wait(dev)
        return out


def _wait(dev: torch.device) -> None:
    """Block until the work queued on `dev`'s current stream is done."""
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


def staged_read_tensor(client, fd: int, offset: int, shape, dtype,
                       *, device: DeviceLike = None) -> torch.Tensor:
    """The host-mediated baseline the paper's design removes: pread() into
    transient buffers, materialize an array, then device transfer. Used by
    benchmarks/tests to count the copies device-direct saves."""
    np_dtype = np.dtype(dtype)
    size = int(np.prod(shape)) * np_dtype.itemsize
    data = client.pread(fd, size, offset)                  # staged copies
    host = np.frombuffer(data, np_dtype).reshape(shape).copy()
    dev = client.device if device is None else resolve_device(device)
    arr = torch.from_numpy(host).to(dev)
    _wait(dev)
    return arr
