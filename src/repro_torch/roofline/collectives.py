"""What a step dispatches, counted as it runs: its collectives, FLOPs,
bytes and live memory. The counterpart of `repro/roofline/hlo.py`.

XLA prints a compiled step's HLO, and `hlo.py` reads the collectives out
of it. Torch prints no HLO, so `StepRecorder`, a TorchDispatchMode, sees
each collective as the step dispatches it, on real tensors or under
FakeTensorMode (the dry-run's trace, in which nothing runs):
`torch.ops._c10d_functional.*` (DTensor's redistributions,
`full_tensor()`) and `torch.ops.c10d.*` (`dist.all_reduce`,
`dist.all_to_all_single`, `dist.all_gather_into_tensor`,
`dist.reduce_scatter_tensor`, the sends of `batch_isend_irecv`; the
sharded model's autograd Functions, `models/context.py`, dispatch them
in the forward and in the backward, which the recorder sees as well).
For each it records the kind, under HLO's names
(`COLLECTIVES`), the bytes of its result and its group's size; the
per-device ring wire bytes follow from those by `hlo.py`'s formulas
(`_wire_bytes`, unchanged):

    all-reduce         2 * S * (n-1)/n      (S = result bytes)
    all-gather         S * (n-1)/n          (result is the gathered buffer)
    reduce-scatter     S * (n-1)            (result is the scattered shard)
    all-to-all         S * (n-1)/n
    collective-permute S

A send is a collective-permute of its tensor; the receive at its other end
is not counted again.

Beside them the recorder computes, per rank (a DTensor counts its local
shard):
- FLOPs, by `torch.utils.flop_counter.FlopCounterMode`: matrix products,
  convolutions and attention, and the four model kernels by the formulas
  registered with their ops (`kernels/*/ops.py`); elementwise ops count 0;
- bytes accessed, computed, not measured: each op's tensor arguments and
  results, elements times element size, summed over the ops (views,
  allocations and metadata ops count 0; collectives count under their
  wire bytes). It stands in for XLA's `bytes accessed`;
- memory: the bytes of the step's argument storages, of its output
  storages (those that are argument storages, updated in place, as
  `alias`), and the peak of the argument bytes plus every storage made
  during the step and still alive, checked after each op.

Unlike `hlo.py`'s counts, which see an op inside a `while` body once,
these count every iteration: the port's loops over layers and
microbatches are Python loops.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

# The kernels' ops register their FLOP formulas when imported, and a
# FlopCounterMode reads the formulas registered when it is made; the
# models import the ops lazily, inside a step, so they are imported here.
import repro_torch.kernels.flash_attention.ops  # noqa: F401,E402
import repro_torch.kernels.rglru_scan.ops  # noqa: F401,E402
import repro_torch.kernels.rwkv6_scan.ops  # noqa: F401,E402

DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.uint16: 2, torch.float16: 2, torch.bfloat16: 2, torch.int32: 4,
    torch.uint32: 4, torch.float32: 4, torch.int64: 8, torch.uint64: 8,
    torch.float64: 8, torch.float8_e4m3fn: 1, torch.float8_e5m2: 1,
    torch.float8_e4m3fnuz: 1, torch.float8_e5m2fnuz: 1,
    torch.complex64: 8, torch.complex128: 16,
}

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all", "collective-broadcast",
)

# op name -> HLO kind. The functional ops return their result; the c10d
# ops write it into their first argument (a tensor or a list of them).
_FUNCTIONAL = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_c10d_functional::broadcast": "collective-broadcast",
}
_IN_PLACE = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::alltoall_": "all-to-all",
    "c10d::broadcast_": "collective-broadcast",
    "c10d::send": "collective-permute",
}
# ops that move no bytes of their own: allocations, metadata, aliases, and
# waits on a collective already counted
_NO_BYTES = {
    "aten::empty", "aten::empty_strided", "aten::empty_like",
    "aten::new_empty", "aten::new_empty_strided", "aten::detach",
    "aten::alias", "aten::_unsafe_view", "aten::_reshape_alias",
    "aten::lift_fresh", "prim::device", "_c10d_functional::wait_tensor",
}


class Collective(NamedTuple):
    kind: str            # one of COLLECTIVES
    result_bytes: int    # the bytes of its result on this rank
    group_size: int      # ranks in its group


def _wire_bytes(kind: str, result_bytes: int, n: int) -> float:
    if kind == "collective-permute":
        return float(result_bytes)   # group-size-independent point-to-point
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / n
    if kind in ("all-gather", "collective-broadcast"):
        return result_bytes * (n - 1) / n
    if kind == "reduce-scatter":
        return float(result_bytes) * (n - 1)
    if kind in ("all-to-all", "ragged-all-to-all"):
        return result_bytes * (n - 1) / n
    return float(result_bytes)       # collective-permute


def collective_stats(record: List[Collective]):
    """Per-kind (count, est. wire bytes) of a recorded step."""
    per_kind_bytes: Dict[str, float] = defaultdict(float)
    per_kind_count: Dict[str, int] = defaultdict(int)
    for c in record:
        per_kind_bytes[c.kind] += _wire_bytes(c.kind, c.result_bytes,
                                              c.group_size)
        per_kind_count[c.kind] += 1
    return dict(per_kind_count), {k: int(v) for k, v in per_kind_bytes.items()}


def collective_bytes(record: List[Collective]) -> Tuple[int, Dict[str, int]]:
    counts, bts = collective_stats(record)
    return int(sum(bts.values())), bts


def collective_count(record: List[Collective]) -> Dict[str, int]:
    counts, _ = collective_stats(record)
    return counts


def _local(t):
    """A DTensor's local shard; any other value as it is."""
    return getattr(t, "_local_tensor", t)


def _tensors(tree) -> list:
    return [_local(t) for t in tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * DTYPE_BYTES.get(t.dtype, 4)


def _group_size(args) -> int:
    """The size of a collective's group: the ProcessGroup argument of a
    c10d op, the group name (its last string argument) of a functional
    one."""
    from torch._C._distributed_c10d import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    if names:
        return _resolve_process_group(names[-1]).size()
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return ProcessGroup.unbox(a).size()
            except RuntimeError:     # a ReduceOp, not the group
                continue
    raise ValueError("a collective without a process group")


def _storages(tree) -> Dict[int, Any]:
    """The distinct storages under a tree's tensors, by identity."""
    out = {}
    for t in _tensors(tree):
        s = t.untyped_storage()
        out[id(s)] = s
    return out


class StepRecorder(TorchDispatchMode):
    """Records what the ops dispatched inside it do on this rank: their
    collectives, bytes accessed, and the live bytes of the storages they
    make, above the storages of `args` (the step's arguments).
    `finish(outputs)` closes the memory record."""

    def __init__(self, args=()):
        super().__init__()
        self.collectives: List[Collective] = []
        self.bytes_accessed = 0
        self._args = _storages(args)
        self.argument_bytes = sum(s.nbytes() for s in self._args.values())
        self._made: Dict[int, Any] = {}     # id -> weakref, made and alive
        self.live = 0
        self.peak = 0

    def _freed(self, key: int, size: int) -> None:
        self._made.pop(key, None)
        self.live -= size

    def _track(self, out) -> None:
        for t in _tensors(out):
            s = t.untyped_storage()
            key = id(s)
            if key in self._args or key in self._made:
                continue
            size = s.nbytes()
            self._made[key] = weakref.ref(s)
            weakref.finalize(s, self._freed, key, size)
            self.live += size
        self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        kind = _FUNCTIONAL.get(name) or _IN_PLACE.get(name)
        if kind is not None:
            result = out if name in _FUNCTIONAL else args[0]
            self.collectives.append(Collective(
                kind, sum(map(_nbytes, _tensors(result))), _group_size(args)))
        elif not func.is_view and name not in _NO_BYTES:
            self.bytes_accessed += sum(map(_nbytes, _tensors((args, kwargs))))
            self.bytes_accessed += sum(map(_nbytes, _tensors(out)))
        self._track(out)
        return out

    def finish(self, outputs) -> Dict[str, int]:
        """The memory record of the step that returned `outputs`, XLA's
        `memory_analysis()` keys: argument, output (alias: the outputs
        that are argument storages), temp (the peak less the arguments and
        the new outputs) and peak bytes."""
        outs = _storages(outputs)
        alias = sum(s.nbytes() for k, s in outs.items() if k in self._args)
        output = sum(s.nbytes() for s in outs.values())
        peak = self.argument_bytes + self.peak
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": output,
                "alias_size_in_bytes": alias,
                "temp_size_in_bytes": max(
                    0, peak - self.argument_bytes - (output - alias)),
                "peak_memory_in_bytes": peak}


class StepCounts(NamedTuple):
    flops: int
    flops_by_op: Dict[str, int]
    bytes_accessed: int
    collectives: List[Collective]
    memory: Dict[str, int]
    outputs: Any


def count_step(fn, *args) -> StepCounts:
    """fn(*args) once under the recorder and the FLOP counter: on real
    tensors, or on fake ones under FakeTensorMode."""
    rec = StepRecorder(args)
    flops = FlopCounterMode(display=False)
    with rec, flops:
        out = fn(*args)
    by_op = {str(op): int(n)
             for op, n in flops.get_flop_counts().get("Global", {}).items()}
    return StepCounts(int(flops.get_total_flops()), by_op,
                      int(rec.bytes_accessed), rec.collectives,
                      rec.finish(out), out)
