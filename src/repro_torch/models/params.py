"""Parameter definitions and their tensors.

Models declare parameters as nested dicts of `ParamDef(shape, axes, init)`
where `axes` are logical axis names, as in the reference
(`repro/models/params.py`). Params are nested dicts of tensors with the
reference's key paths and shapes, the stacked layer axis first.

A rules table maps logical axes to mesh axes (`DEFAULT_RULES`), giving a
spec per leaf: a tuple shaped like the reference's PartitionSpec, one
entry a dim, each `None`, a mesh axis name or a tuple of names. A dim
whose size the mesh axes do not divide is replicated (MQA's kv = 1,
whisper's 51865 vocab, 10-head attention). The spec functions read only
a mesh's axis names and sizes (`MeshShape`, or a DeviceMesh), so they run
on a mesh that no process group backs; `placements` turns a spec into
DTensor placements on a real `DeviceMesh`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.device import (DeviceLike, resolve_device, trace_device,
                                tracing)

Axes = Tuple[Optional[str], ...]
Spec = Tuple[Union[None, str, Tuple[str, ...]], ...]


@dataclass
class ParamDef:
    shape: Tuple[int, ...]
    axes: Axes                       # logical axis name per dim (None = replicated)
    init: str = "normal"             # normal | zeros | ones | embed
    scale: Optional[float] = None    # overrides fan-in scaling


def pdef(shape: Sequence[int], axes: Sequence[Optional[str]], init: str = "normal",
         scale: Optional[float] = None) -> ParamDef:
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    return ParamDef(shape, axes, init, scale)


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in sorted key order, the order jax.tree uses."""
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _leaves(node, prefix + (key,))
        else:
            yield prefix + (key,), node


def tree_leaves(tree: Dict[str, Any]):
    """The leaves of a nested dict in sorted key order (jax.tree's)."""
    return [leaf for _, leaf in _leaves(tree)]


def tree_map(fn, *trees: Dict[str, Any]) -> Dict[str, Any]:
    """fn over the leaves of nested dicts of one structure, keys in sorted
    order, as jax.tree.map walks them."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in sorted(first)}
    return fn(*trees)


def _init_leaf(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device, shape=None) -> torch.Tensor:
    """A leaf drawn by `d`'s rule, at `shape` (a shard's; d.shape by
    default) with d.shape's fan-in."""
    shape = d.shape if shape is None else shape
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    if d.init == "embed":
        return x.mul_(0.02).to(dtype)
    # fan-in scaled normal over the last-but-one dim (input dim)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
    scale = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return x.mul_(scale).to(dtype)


def init_params(defs: Dict[str, Any], generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None, mesh=None,
                rules=None) -> Dict[str, Any]:
    """Materialise a ParamDef tree into tensors on `device` (the CUDA card
    unless the caller asks for the CPU), leaf by leaf in sorted key order
    from `generator`, which must live on that device. On a DeviceMesh
    each leaf is the DTensor at its `param_pspecs` spec of which this rank
    draws only its shard (no rank holds a whole leaf; the shards of one
    leaf are independent draws).

    The distributions are the reference's (fan-in normal, embed 0.02,
    ones, zeros), but the values are not: a torch.Generator does not give
    jax.random's numbers. To run both packages on the same weights, make
    them with the reference and carry them across with
    `params_from_numpy`."""
    device = resolve_device(device)
    specs = (None if mesh is None
             else tree_leaves(param_pspecs(defs, mesh, rules)))
    out: Dict[str, Any] = {}
    for i, (path, d) in enumerate(_leaves(defs)):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if mesh is None:
            node[path[-1]] = _init_leaf(d, generator, dtype, device)
            continue
        pl = placements(specs[i], mesh)
        node[path[-1]] = DTensor.from_local(
            _init_leaf(d, generator, dtype, device,
                       local_shape(d.shape, pl, mesh)), mesh, pl,
            run_check=False)
    return out


def sharded_zeros(shape: Sequence[int], dtype: torch.dtype, device, mesh,
                  s: Optional[Spec]):
    """Zeros of global `shape` as the DTensor at spec `s` (fitted) on
    `mesh`, of which this rank allocates only its shard."""
    pl = placements(fit_spec(shape, s, mesh), mesh)
    return DTensor.from_local(torch.zeros(local_shape(shape, pl, mesh),
                                          dtype=dtype, device=device),
                              mesh, pl, run_check=False)


def abstract(shape: Sequence[int], dtype: torch.dtype,
             device: DeviceLike = None, mesh=None,
             s: Optional[Spec] = None) -> torch.Tensor:
    """A tensor of `shape` and `dtype` that allocates nothing: a fake one,
    made under the active FakeTensorMode on `device` (`trace_device()` by
    default). On a DeviceMesh it is the DTensor at spec `s` over this
    rank's fake local shard, built by `DTensor.from_local` with no check:
    no collective is recorded, as the reference's compiled step receives
    its arguments already sharded."""
    device = trace_device() if device is None else torch.device(device)
    if not tracing():
        raise RuntimeError("abstract tensors are made under FakeTensorMode")
    if mesh is None:
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    return sharded_zeros(shape, dtype, device, mesh, s)


def local_shape(shape: Sequence[int], pl, mesh) -> Tuple[int, ...]:
    """The shape of one rank's shard of a tensor of `shape` at DTensor
    placements `pl` on `mesh` (even splits)."""
    local = list(shape)
    for size, p in zip(mesh_shape(mesh).shape, pl):
        if p.is_shard():
            local[p.dim] //= size
    return tuple(local)


def local_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """The params a rank computes with: each DTensor leaf's local shard
    (its `param_pspecs` spec fitted to the mesh: heads, mlp columns,
    vocab and experts along "model", the fsdp dim along "data"), as a
    tensor of its own sharing the shard's storage (no copy), which the
    train step differentiates; any other leaf as it is."""
    return tree_map(lambda p: p.to_local().detach() if isinstance(p, DTensor)
                    else p, params)


def abstract_params(defs: Dict[str, Any], dtype: torch.dtype,
                    device: DeviceLike = None, mesh=None, rules=None):
    """The params `init_params` would make from `defs`, in their shapes
    and `dtype`, with nothing allocated (`abstract`): the counterpart of
    the reference's `abstract_params`. On a DeviceMesh each leaf is a
    DTensor at its `param_pspecs` spec."""
    specs = defs if mesh is None else param_pspecs(defs, mesh, rules)
    return tree_map(lambda d, s: abstract(d.shape, dtype, device, mesh,
                                          None if mesh is None else s),
                    defs, specs)


def count_params(defs: Dict[str, Any]) -> int:
    return sum(int(np.prod(d.shape)) for _, d in _leaves(defs))


def _from_numpy(a, device: torch.device,
                dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":            # ml_dtypes: torch refuses it
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """The reference's params, as a nested dict of numpy arrays with its
    key paths (stacked layer axis first), as the port's tensors on
    `device`, cast to `dtype` if given. bfloat16 leaves arrive as
    ml_dtypes arrays and cross through a uint16 view."""
    device = resolve_device(device)
    return tree_map(lambda a: _from_numpy(a, device, dtype), tree)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                      # what the reference's arrays use
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The reverse of `params_from_numpy`: numpy arrays on the host, with
    bfloat16 leaves as ml_dtypes arrays."""
    return tree_map(_to_numpy, params)


# ---------------------------------------------------------------------------
# Logical-axis -> mesh-axis rules

# Default rules for the ("pod", "data", "model") production mesh. "batch"-like
# logical axes map to the compound data-parallel axes; model-parallel axes map
# to "model". A logical axis absent here is replicated.
DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "zero": ("pod", "data"),        # ZeRO-1 optimizer-state sharding axis
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "rnn": "model",
    "embed": None,                   # residual stream replicated under TP
    "seq": None,
    "sp_seq": "data",               # sequence-parallel prefill (opt-in)
}


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, with no devices behind it: what the
    spec functions read."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def mesh_shape(mesh) -> MeshShape:
    """The MeshShape of a MeshShape or a torch DeviceMesh."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def _names(p) -> Tuple[str, ...]:
    if p is None:
        return ()
    return tuple(p) if isinstance(p, (tuple, list)) else (p,)


def spec(*parts) -> Spec:
    """A spec from its entries, a one-name tuple written as the name, as
    PartitionSpec normalises it."""
    return tuple(p[0] if isinstance(p, (tuple, list)) and len(p) == 1
                 else (tuple(p) if isinstance(p, list) else p)
                 for p in parts)


def _mesh_axes_size(mesh, axes) -> int:
    """The product of the sizes of mesh axes `axes` (an axis the mesh
    lacks counts 1)."""
    sizes = dict(zip(*mesh_shape(mesh)))
    return math.prod(sizes.get(a, 1) for a in _names(axes))


def spec_for(mesh, axes: Axes, shape: Tuple[int, ...],
             rules: Optional[Dict[str, Any]] = None) -> Spec:
    """The spec of one leaf. Replicates any non-divisible dim."""
    rules = rules or DEFAULT_RULES
    return fit_spec(shape, tuple(None if ax is None else rules.get(ax)
                                 for ax in axes), mesh)


def param_pspecs(defs: Dict[str, Any], mesh, rules=None):
    """The spec tree mirroring a ParamDef tree."""
    return tree_map(lambda d: spec_for(mesh, d.axes, d.shape, rules), defs)


def zero1_pspecs(defs: Dict[str, Any], mesh, rules=None):
    """Optimizer-moment specs: the param specs, with the largest
    not-yet-sharded divisible dim also sharded over the data axes that the
    param's own spec leaves free (ZeRO-1)."""
    rules = rules or DEFAULT_RULES
    names = mesh_shape(mesh).axis_names
    zaxes = tuple(a for a in _names(rules.get("zero", ("pod", "data")))
                  if a in names)

    def one(d: ParamDef) -> Spec:
        base = spec_for(mesh, d.axes, d.shape, rules)
        used = {a for p in base for a in _names(p)}
        avail = tuple(a for a in zaxes if a not in used)
        asize = _mesh_axes_size(mesh, avail)
        if not avail or asize <= 1:
            return base
        cand = [(dim, i) for i, (dim, p) in enumerate(zip(d.shape, base))
                if p is None and dim % asize == 0]
        if not cand:
            return base
        parts = list(base)
        parts[max(cand)[1]] = avail
        return spec(*parts)

    return tree_map(one, defs)


def fit_spec(shape: Sequence[int], s: Optional[Spec], mesh) -> Spec:
    """`s` padded with None to len(shape), each entry's mesh axes cut to
    those of `mesh` (no "pod" on a single-pod mesh) and kept only if they
    divide the dim, the rest replicated (the reference's `spec_for`,
    `constraint` and `shardings_for`)."""
    names = mesh_shape(mesh).axis_names
    s = tuple(s or ()) + (None,) * (len(shape) - len(tuple(s or ())))
    parts = []
    for dim, p in zip(shape, s):
        axes = tuple(a for a in _names(p) if a in names)
        n = _mesh_axes_size(mesh, axes)
        parts.append(axes if n > 1 and dim % n == 0 else None)
    return spec(*parts)


def placements(s: Spec, mesh) -> list:
    """DTensor placements of spec `s` on `mesh`: Shard(dim) on each mesh
    dim that shards tensor dim `dim`, Replicate() elsewhere. A dim split
    over several mesh dims takes them major to minor, which is the
    PartitionSpec's order only when it follows the mesh's."""
    names = mesh_shape(mesh).axis_names
    out = [Replicate()] * len(names)
    for dim, p in enumerate(s):
        idx = [names.index(a) for a in _names(p)]
        if idx != sorted(idx):
            raise ValueError(f"spec {s}: mesh axes {p} out of the mesh's "
                             f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def param_shardings(defs: Dict[str, Any], mesh, rules=None):
    """DTensor placements on `mesh` (a DeviceMesh) mirroring a ParamDef
    tree."""
    return tree_map(lambda s: placements(s, mesh),
                    param_pspecs(defs, mesh, rules))


def place(t, mesh, pl: tuple):
    """`t` as a DTensor on `mesh` (a DeviceMesh) at placements `pl`. A
    DTensor is redistributed (returned as it is if already there); any
    other tensor or array is the global value, of which each rank keeps
    its own shard with no communication."""
    if isinstance(t, DTensor):
        return t if t.placements == pl else t.redistribute(mesh, pl)
    return distribute_tensor(torch.as_tensor(t), mesh, list(pl),
                             src_data_rank=None)
