"""float8_e4m3fn rounding, as a lower-precision stand-in for bfloat16."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def q8(t: torch.Tensor, dim=None) -> torch.Tensor:
    """t rounded to float8_e4m3fn under a scale that maps its largest
    magnitude (over the whole tensor, or along `dim`) to 448, returned in
    float32."""
    t = t.float()
    amax = (t.abs().amax() if dim is None
            else t.abs().amax(dim=dim, keepdim=True))
    scale = torch.clamp_min(amax, 1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with a rounded to float8 a row at a time and b as a whole,
    the products summed in float32."""
    return q8(a, dim=-1) @ q8(b)
