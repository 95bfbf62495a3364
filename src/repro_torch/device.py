"""The one rule every entry point of the port follows for its device."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the CUDA card. Asking for the card where there is
    none raises: the port never drops quietly to the CPU, the caller asks
    for it with `device="cpu"`."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_of(x: Optional[torch.Tensor], device: DeviceLike) -> torch.device:
    """The device an op runs on: a tensor argument's own device, else the
    resolved `device` argument."""
    if isinstance(x, torch.Tensor) and device is None:
        return x.device
    return resolve_device(device)
