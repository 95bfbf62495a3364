"""Device context construction for the launch entry points.

One card for now: `make_host_mesh_ctx` returns the one-device context. The
production meshes (and the reference's TPU roofline constants) wait for
the multi-device and roofline slices (ROADMAP Queue 1).
"""
from __future__ import annotations

from repro_torch.device import DeviceLike
from repro_torch.models.context import MeshCtx, single_device_ctx


def make_host_mesh_ctx(cfg, device: DeviceLike = None) -> MeshCtx:
    """The context on one local device (the CUDA card unless the caller
    asks for the CPU)."""
    return single_device_ctx(cfg, device)
