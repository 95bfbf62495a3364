"""Plain PyTorch version of the RG-LRU scan kernel.

    h_t = a_t * h_{t-1} + b_t     over axis 1 of (B, T, R), in float32

as a log-step doubling scan: after the step of distance d, (A_t, H_t)
compose the d most recent steps ending at t, so log2(T) whole-tensor
passes give every h_t. The same function as the reference's
`rglru_scan_ref` (`repro/kernels/rglru_scan/ref.py`, an associative scan),
summed in another order. The CPU tests use it, the model's plain path
(`models/recurrent.py:_lru_scan`) is it, and chip_smoke.py holds the CUDA
kernel against it on the card.
"""
from __future__ import annotations

from typing import Optional

import torch


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor,
                   h0: Optional[torch.Tensor] = None,
                   reverse: bool = False) -> torch.Tensor:
    """a, b (B,T,R); h0 (B,R) or None. Returns h (B,T,R) float32. With
    `reverse`, h_t = a_t * h_{t+1} + b_t from t = T-1 down, h_T = h0 (the
    kernel's reverse mode)."""
    a = a.float()
    b = b.float()
    if reverse:
        a, b = a.flip(1), b.flip(1)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    T = a.shape[1]
    d = 1
    while d < T:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b.flip(1) if reverse else b
