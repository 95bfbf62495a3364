"""The one rule every entry point of the port follows for its device."""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def tracing() -> bool:
    """Whether a FakeTensorMode is active: a trace (the dry-run's), in
    which no op runs."""
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def trace_device() -> torch.device:
    """The device a trace's fake tensors claim: the card, where torch is
    built for CUDA (a card need not be present); else "meta". On a build
    without CUDA no device guard is registered for "cuda", so indexing a
    fake CUDA tensor from Python raises. Either way every kernel wrapper
    takes its card branch (anything but a CPU tensor) and reaches its op's
    fake implementation."""
    if torch.backends.cuda.is_built():
        return torch.device("cuda", 0)
    return torch.device("meta")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`None` means the CUDA card. Asking for the card where there is
    none raises: the port never drops quietly to the CPU, the caller asks
    for it with `device="cpu"`. Under FakeTensorMode nothing runs, so the
    card need not be present, and "meta" (`trace_device`) is taken too."""
    dev = torch.device("cuda" if device is None else device)
    if tracing() and dev.type in ("cuda", "meta"):
        return dev
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
