"""MeshCtx: what a model needs to know about where it runs, the
counterpart of `repro/models/context.py`, and the collectives its
per-rank code calls.

Without a mesh (`single_device_ctx`) the context holds only the device,
and reads as the reference's 1 x 1 ("data", "model") mesh: `constraint`
is the identity and the data- and model-parallel sizes are 1. GSPMD
emits no collective on a 1 x 1 mesh, and neither does this context.

With a mesh (`make_mesh`, a torch `DeviceMesh` over an initialised
process group) params, moments, batches and caches are DTensors placed by
the rules' specs (`models/params.py`), and `constraint` redistributes a
DTensor to the placements of a spec. The model code runs on each rank's
local tensors: its batch shard and its params' local shards, in every
family, which is what XLA's SPMD partitioner makes of the reference's
specs (the Megatron layout): heads, mlp columns, recurrent channels,
vocab and experts over "model", the fsdp dim over "data". The collectives between
them are explicit, as autograd Functions on `MeshCtx.group`:

    copy_to_model      identity forward, all-reduce over "model" backward
    reduce_from_model  all-reduce over "model" forward, identity backward
    gather_from_model  all-gather over "model" forward, its slice backward
    scatter_to_model   its slice forward, all-gather over "model" backward
    gather_fsdp        all-gather over "data" forward, reduce-scatter back

Each returns its input untouched without a mesh or on a group of one
rank, so the one-device path and a one-rank mesh run the same ops. No
param is gathered whole; the reference's own shard_map regions
(`moe_ffn`, `gpipe_forward`) are explicit per-rank code over the mesh's
groups. A mesh may also be a
`MeshShape` (names and sizes only), on which the spec functions run but
nothing can be placed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import (DEFAULT_RULES, MeshShape, Spec,
                                       _mesh_axes_size, fit_spec,
                                       mesh_shape, placements, spec)

ONE_DEVICE = MeshShape(("data", "model"), (1, 1))


# the backend a mesh's collectives need on each device type: NCCL on the
# card (gloo would move a card's tensors through the host), any on the CPU
BACKEND_FOR = {"cuda": ("nccl",), "cpu": ("gloo", "mpi")}


def make_mesh(shape, axis_names, device_type: str = "cuda") -> DeviceMesh:
    """A DeviceMesh of `shape` named `axis_names` on `device_type` over the
    default process group, which must be initialised with exactly that
    many ranks and with a backend for that device type (NCCL for "cuda")."""
    shape, names = tuple(int(n) for n in shape), tuple(axis_names)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} "
                           "ranks, initialised first")
    config = dist.get_backend_config()
    backends = dict(item.split(":") for item in config.split(","))
    if backends.get(device_type) not in BACKEND_FOR[device_type]:
        raise RuntimeError(f"a {device_type} mesh needs a process group with "
                           f"a {' or '.join(BACKEND_FOR[device_type])} "
                           f"backend for {device_type}; this one has "
                           f"{config}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


@dataclass
class MeshCtx:
    device: torch.device
    mesh: Any = None                  # DeviceMesh | MeshShape | None
    rules: Dict[str, Any] = field(default_factory=lambda: dict(DEFAULT_RULES))

    @property
    def shape(self) -> MeshShape:
        return ONE_DEVICE if self.mesh is None else mesh_shape(self.mesh)

    @property
    def device_mesh(self) -> Optional[DeviceMesh]:
        """The DeviceMesh, or None without one (no mesh, or a MeshShape)."""
        return self.mesh if isinstance(self.mesh, DeviceMesh) else None

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.shape.axis_names if a != "model")

    @property
    def model_axis(self) -> Optional[str]:
        return "model" if "model" in self.shape.axis_names else None

    def batch_spec(self, *trailing) -> Spec:
        return spec(self.batch_axes, *trailing)

    def constraint(self, x: torch.Tensor, s: Optional[Spec] = None):
        """A DTensor redistributed to spec `s`, with every dim its mesh
        axes do not divide replicated (the reference's
        with_sharding_constraint); any other tensor as it is."""
        if not isinstance(x, DTensor):
            return x
        pl = placements(fit_spec(x.shape, s, self.mesh), self.mesh)
        return x if tuple(x.placements) == tuple(pl) else x.redistribute(
            self.mesh, pl)

    def size(self, axes) -> int:
        return _mesh_axes_size(self.shape, axes)

    def dp_size(self) -> int:
        return self.size(self.batch_axes)

    def tp_size(self) -> int:
        return self.size(("model",))

    def coordinate(self, axis: str) -> int:
        """This rank's index along `axis` (0 without a mesh)."""
        m = self.device_mesh
        return 0 if m is None else m.get_local_rank(axis)

    def group(self, axis: str):
        """The process group along `axis` through this rank."""
        return self.device_mesh.get_group(axis)


def make_rules(cfg) -> Dict[str, Any]:
    rules = dict(DEFAULT_RULES)
    rules["fsdp"] = ("data",) if getattr(cfg, "fsdp", False) else None
    return rules


def single_device_ctx(cfg=None, device: DeviceLike = None) -> MeshCtx:
    """The one-device context on `device` (the CUDA card unless the caller
    asks for the CPU), with no mesh."""
    return MeshCtx(device=resolve_device(device),
                   rules=make_rules(cfg) if cfg is not None
                   else dict(DEFAULT_RULES))


def mesh_ctx(cfg, mesh) -> MeshCtx:
    """The context on `mesh` (a DeviceMesh), on this rank's device."""
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    return MeshCtx(device=device, mesh=mesh, rules=make_rules(cfg))


# ---------------------------------------------------------------------------
# Collectives of the per-rank model code (NCCL captures each of them in a
# CUDA graph; the dry-run's recorder counts them as c10d ops)

def _group(mctx: Optional[MeshCtx], axis: str):
    """The process group along `axis`, or None without a mesh or where the
    axis has one rank (no collective is needed there)."""
    if mctx is None or mctx.device_mesh is None or mctx.size((axis,)) <= 1:
        return None
    return mctx.group(axis)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' blocks of `group` along `dim`, in rank order."""
    n = dist.get_world_size(group)
    xm = x.movedim(dim, 0).contiguous()
    out = xm.new_empty((n * xm.shape[0],) + tuple(xm.shape[1:]))
    dist.all_gather_into_tensor(out, xm, group=group)
    return out.movedim(0, dim)


def _block_of(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of `x` along `dim` (a view)."""
    n = dist.get_world_size(group)
    size = x.shape[dim] // n
    return x.narrow(dim, dist.get_rank(group) * size, size)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block_of(g, ctx.dim, ctx.group), None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block_of(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherFSDP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        gm = g.movedim(ctx.dim, 0).contiguous()
        out = gm.new_empty((gm.shape[0] // n,) + tuple(gm.shape[1:]))
        dist.reduce_scatter_tensor(out, gm, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


def copy_to_model(x: torch.Tensor, mctx: Optional[MeshCtx]) -> torch.Tensor:
    """x as it is; its gradient summed over "model". Where a tensor
    replicated along "model" feeds a rank's shard of the work (column
    parallel products, its heads, its token slice), each rank's gradient
    of it is a part of the whole."""
    group = _group(mctx, "model")
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor,
                      mctx: Optional[MeshCtx]) -> torch.Tensor:
    """The sum of every "model" rank's x (a row-parallel product's partial
    output); its gradient passes as it is, since it is the same on every
    rank."""
    group = _group(mctx, "model")
    return x if group is None else _ReduceFromModel.apply(x, group)


def gather_from_model(x: torch.Tensor, dim: int,
                      mctx: Optional[MeshCtx]) -> torch.Tensor:
    """The "model" ranks' blocks of x along `dim`, whole; the gradient of
    the whole is the same on every rank, and each keeps its block of it."""
    group = _group(mctx, "model")
    return x if group is None else _GatherFromModel.apply(x, dim, group)


def scatter_to_model(x: torch.Tensor, dim: int,
                     mctx: Optional[MeshCtx]) -> torch.Tensor:
    """This "model" rank's block of x along `dim` (x is the same on every
    rank); the ranks' gradients of their blocks, gathered, are x's."""
    group = _group(mctx, "model")
    return x if group is None else _ScatterToModel.apply(x, dim, group)


def gather_fsdp(w: torch.Tensor, dim: int, mctx: Optional[MeshCtx],
                whole: Optional[int] = None) -> torch.Tensor:
    """A param's fsdp dim `dim` gathered over "data" (the fsdp rule's
    axis), where it is sharded: always with `whole` None, else where
    w.shape[dim] is less than `whole`. The gradient is summed over "data"
    and each rank keeps its block (a reduce-scatter), which is the data
    ranks' sum a sharded leaf's gradient needs."""
    group = _group(mctx, "data")
    if group is None or (whole is not None and w.shape[dim] >= whole):
        return w
    return _GatherFSDP.apply(w, dim, group)
