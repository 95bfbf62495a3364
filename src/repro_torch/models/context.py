"""MeshCtx: what a model needs to know about where it runs.

On one device the context holds only the device: `constraint` is the
identity and the data- and model-parallel sizes are 1. The reference's
mesh, rules and sharding constraints (`repro/models/context.py`) wait for
the multi-device slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass
class MeshCtx:
    device: torch.device

    def batch_spec(self, *trailing) -> None:
        return None

    def constraint(self, x: torch.Tensor, spec: Any = None) -> torch.Tensor:
        return x

    def dp_size(self) -> int:
        return 1

    def tp_size(self) -> int:
        return 1


def single_device_ctx(cfg=None, device: DeviceLike = None) -> MeshCtx:
    """The one-device context on `device` (the CUDA card unless the caller
    asks for the CPU)."""
    return MeshCtx(device=resolve_device(device))
