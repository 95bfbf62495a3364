"""Mesh construction for the launch entry points, the counterpart of
`repro/launch/mesh.py`.

Functions, not module-level constants: importing this module touches no
process group. The production meshes are (16, 16) over ("data",
"model") and (2, 16, 16) over ("pod", "data", "model"); their shapes
(`production_mesh_shape`) are all the spec functions need. The
hardware constants below are one NVIDIA H100 SXM's, the counterparts of
the reference's TPU v5e figures (`repro/launch/mesh.py:35-38`), which are
not carried over; the roofline (`roofline/analytic.py`) and
`chip_smoke.py`'s bounds read them from here.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.context import (MeshCtx, make_mesh, mesh_ctx,
                                        single_device_ctx)
from repro_torch.models.params import MeshShape


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False):
    """The production DeviceMesh on the cards, over an initialised NCCL
    process group of 256 (or, multi-pod, 512) ranks."""
    ms = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(ms.shape, ms.axis_names)


def make_mesh_ctx(cfg, *, multi_pod: bool = False) -> MeshCtx:
    return mesh_ctx(cfg, make_production_mesh(multi_pod=multi_pod))


def make_host_mesh_ctx(cfg, data: Optional[int] = None,
                       model: Optional[int] = None,
                       device: DeviceLike = None) -> MeshCtx:
    """On `device` (the CUDA card unless the caller asks for the CPU):
    with `data` or `model` given, a (data, model) mesh over the
    initialised process group, whose backend must serve that device (NCCL
    for the card); otherwise the one-device context, as the launch entry
    points use."""
    if data is None and model is None:
        return single_device_ctx(cfg, device)
    mesh = make_mesh((data or 1, model or 1), ("data", "model"),
                     resolve_device(device).type)
    return mesh_ctx(cfg, mesh)


# NVIDIA H100 SXM hardware constants used by the roofline (per card).
PEAK_FLOPS_BF16 = 989e12    # FLOP/s, dense bf16 (H100 SXM data sheet)
HBM_BW = 3.35e12            # B/s, HBM3 (H100 SXM data sheet)
# B/s each way: NVLink 4, 900 GB/s bidirectional to the host's other cards
# (H100 SXM data sheet), the counterpart of a TPU's per-link ICI rate. A
# 16-way "model" axis spans two 8-card NVLink domains, where InfiniBand
# would bound it; the roofline keeps this one rate.
NVLINK_BW = 450e9
