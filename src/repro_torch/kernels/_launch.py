"""What the kernels' wrappers share around a launch: the C call on the
input's card, on PyTorch's current stream there (`call_on`, every
wrapper); the check of the storage kernels' input (`check_bytes`,
`stream_cipher` and `fletcher`); and whether a call launches its kernel
or records it into a CUDA graph being captured (`launching`, which the
model kernels' launch counts read).

A 1 MiB extent takes the storage kernels some 2 us on an H100, so the
host call is most of a checksum's cost; these do only what the launch
needs. The card is entered (`torch.cuda.device`) only when the tensor is
not on the current one, and the stream is read as the raw pointer
PyTorch's own generated code reads (`torch._C._cuda_getCurrentRawStream`),
without making a `torch.cuda.Stream`. Under capture that is the capturing
stream, so a wrapper's launch lands in the graph.

A trace (FakeTensorMode, the dry-run's) reaches a kernel only through its
op's fake implementation (`kernels/*/ops.py`); a fake tensor handed to a
wrapper itself is refused (`refuse_fake`), since its `data_ptr()` reads 0
and the kernel would launch on null pointers.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

BYTE_DTYPES = (torch.uint8, torch.uint32)


def check_bytes(x: torch.Tensor, name: str) -> None:
    """Raises unless x is a contiguous, non-empty uint8 or uint32 CUDA
    tensor."""
    if (x.dtype not in BYTE_DTYPES or not x.is_cuda
            or not x.is_contiguous() or x.numel() == 0):
        raise ValueError(f"{name} takes a contiguous, non-empty uint8 or "
                         f"uint32 CUDA tensor, got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}")


def call_on(index: int, fn: Callable, *args):
    """fn(*args, stream) on card `index`, `stream` being PyTorch's current
    stream there (as an int); returns what fn returns."""
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def launching() -> bool:
    """Whether a kernel call on the current CUDA stream launches now:
    False while the stream is being captured into a CUDA graph, where the
    call records its kernel and each replay of the graph launches it."""
    return not torch.cuda.is_current_stream_capturing()


def refuse_fake(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raises if a tensor is fake: a kernel is traced through its op's
    fake implementation, never launched on a fake tensor's pointers."""
    for t in tensors:
        if isinstance(t, FakeTensor):
            raise RuntimeError(f"{name} handed a FakeTensor: a trace reaches "
                               "the kernel through its op's fake "
                               "implementation, not its launch")
