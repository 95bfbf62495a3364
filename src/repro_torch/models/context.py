"""MeshCtx: what a model needs to know about where it runs, the
counterpart of `repro/models/context.py`.

Without a mesh (`single_device_ctx`) the context holds only the device,
and reads as the reference's 1 x 1 ("data", "model") mesh: `constraint`
is the identity and the data- and model-parallel sizes are 1. GSPMD
emits no collective on a 1 x 1 mesh, and neither does this context.

With a mesh (`make_mesh`, a torch `DeviceMesh` over an initialised
process group) params, moments, batches and caches are DTensors placed by
the rules' specs (`models/params.py`), `constraint` redistributes a
DTensor to the placements of a spec, and the model code runs on each
rank's local tensors: its batch shard, with the params gathered, and the
reference's own shard_map regions (`moe_ffn`, `gpipe_forward`) as
explicit per-rank code over the mesh's groups. A mesh may also be a
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
                                       _mesh_axes_size, fit_spec, mesh_shape,
                                       placements, spec)

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
