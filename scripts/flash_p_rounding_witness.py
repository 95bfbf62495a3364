#!/usr/bin/env python3
"""Why the bf16 flash forward feeds p to p.v in two bf16 parts.

    python3 scripts/flash_p_rounding_witness.py [--layers N]

From the root of a checkout, on a CUDA card. It makes granite-3-2b at full
width from a seed (as chip_smoke.py's serve phase does), runs one prefill
wave of 4 prompts of 1024 tokens through the flash path and records every
layer's attention inputs. For the first N layers (default 8) it prints the
largest |q|, |k| and |v|, then holds three outputs against the plain
version (`attention_ref`, float32 p.v) at the reference's bf16 tolerance
(2e-2, atol = rtol, as chip_smoke.py's per-layer check): the port's kernel,
PyTorch's scaled_dot_product_attention (which rounds p to bf16 once) and a
float32 emulation that rounds only p to bf16. The last two show the
rounding alone breaking the tolerance on these activations; the kernel,
which splits p into bf16(p) and bf16(p - bf16(p)), holds.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh_ctx  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

TOL = 2e-2


def rounded_p(q, k, v, scale):
    """Causal attention in float32 with only p rounded to bf16 before
    p.v (l from the float32 p)."""
    B, T, H, D = q.shape
    KH = k.shape[2]
    s = torch.einsum("btkgd,bskd->bkgts",
                     q.float().reshape(B, T, KH, H // KH, D), k.float())
    s = (s * scale).masked_fill(
        ~torch.ones(T, T, dtype=torch.bool, device=q.device).tril(),
        ref.MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bkgts,bskd->bkgtd", p.bfloat16().float(), v.float())
    out = out / p.sum(-1, keepdim=True)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, D)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(cs.card_line())
    cfg = get_config("granite-3-2b").replace(attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(api.param_defs(), gen,
                         getattr(torch, cfg.param_dtype))
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (4, 1024), dtype=np.int32))
    calls = []
    kernel_path = ops.flash_attention

    def recording(q, k, v, **kw):
        out = kernel_path(q, k, v, **kw)
        calls.append((q, k, v, kw, out))
        return out

    ops.flash_attention = recording          # layers.attention looks it up
    try:
        with torch.inference_mode():
            api.prefill(params, {"tokens": tokens}, mctx)
    finally:
        ops.flash_attention = kernel_path
    for i, (q, k, v, kw, out) in enumerate(calls[:args.layers]):
        scale = kw["scale"] or q.shape[-1] ** -0.5
        want = ref.attention_ref(q, k, v, scale=scale, causal=kw["causal"],
                                 window=kw["window"], softcap=kw["softcap"])
        lib = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), is_causal=True,
            enable_gqa=True, scale=scale).transpose(1, 2)
        row = [f"layer {i}: |q| {q.abs().max().item():.1f}, |k| "
               f"{k.abs().max().item():.1f}, |v| {v.abs().max().item():.1f}"]
        for name, got in (("kernel", out), ("sdpa", lib),
                          ("bf16 p", rounded_p(q, k, v, scale))):
            err, ok = cs.in_tolerance(got, want, TOL)
            row.append(f"{name} max abs err {err:.4f} "
                       f"{'within' if ok else 'OUTSIDE'} {TOL}")
        print("; ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
