#!/usr/bin/env python3
"""Which WKV version is exact on the rwkv6-1.6b serve path's inputs.

    python3 scripts/wkv6_serve_accuracy_witness.py [--layers N]

From the root of a checkout, on a CUDA card. It makes rwkv6-1.6b at full
width from a seed (as chip_smoke.py's recurrent phase does), runs one
prefill wave of 4 prompts of 1024 tokens through the kernel path and
records every layer's wkv6 inputs. For the first N layers (default 24) it
prints the smallest decay w and then holds three outputs against the same
recurrence run sequentially in float64: the port's kernel (`ops.wkv6`),
the chunked plain version (`ref.wkv_plain`, the reference's form, whose
exponents are cum - lw) and the float32 sequential version
(`ref.wkv_ref`), each with its largest error and its count of elements
outside 3e-4 (atol = rtol). Under the path's strong decays (w down to
1e-21) the chunked plain version's error reaches the tolerance, while the
kernel, whose exclusive cumulative sums are taken from the row before,
stays near the float32 sequential version.
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ref  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh_ctx  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

TOL = 3e-4


def wkv_f64(r, k, v, w, u, s0=None):
    """The recurrence step by step in float64 (y only)."""
    r, k, v, w, u = (x.double() for x in (r, k, v, w, u))
    B, T, H, hd = r.shape
    s = (torch.zeros(B, H, hd, hd, dtype=torch.float64, device=r.device)
         if s0 is None else s0.double())
    ys = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                               u[None, :, :, None] * kv + s))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, 1)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(cs.card_line())
    cfg = get_config("rwkv6-1.6b").replace(attn_impl="flash")
    api = ModelAPI(cfg)
    mctx = make_host_mesh_ctx(cfg)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    params = init_params(api.param_defs(), gen,
                         getattr(torch, cfg.param_dtype))
    tokens = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (4, 1024), dtype=np.int32))
    calls = []
    kernel_path = ops.wkv6

    def recording(*xs):
        out = kernel_path(*xs)
        calls.append((xs, out))
        return out

    ops.wkv6 = recording                     # models/rwkv.py looks it up
    try:
        with torch.inference_mode():
            api.prefill(params, {"tokens": tokens}, mctx)
    finally:
        ops.wkv6 = kernel_path
    worst = {}
    for i, (xs, out) in enumerate(calls[:args.layers]):
        want = wkv_f64(*xs)
        row = [f"layer {i}: w min {xs[3].min().item():.3g}"]
        for name, got in (("kernel", out[0]), ("chunked plain",
                                               ref.wkv_plain(*xs)[0]),
                          ("sequential f32", ref.wkv_ref(*xs)[0])):
            err = (got.double() - want).abs()
            bad = int((err > TOL + TOL * want.abs()).sum())
            worst[name] = max(worst.get(name, 0.0), float(err.max()))
            row.append(f"{name} max abs err {float(err.max()):.3e}, "
                       f"{bad} outside {TOL}")
        print("; ".join(row), flush=True)
    print("largest error against float64 over the layers: "
          + ", ".join(f"{name} {e:.3e}" for name, e in worst.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
