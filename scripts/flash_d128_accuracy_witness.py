#!/usr/bin/env python3
"""How far the D=128 flash calls of dbrx's and llama-3.2-vision's prefill
are from exact attention, beside the plain version and SDPA.

    python3 scripts/flash_d128_accuracy_witness.py [--seed N]

From the root of a checkout, on a CUDA card. It makes dbrx-132b (4
layers) and llama-3.2-vision-90b (2 super-blocks, seeded nonzero gates)
at full width from a seed, as chip_smoke.py's moe and vlm phases do, runs
one prefill wave of 4 prompts of 1024 tokens through the flash path and
records every flash call. For each call it prints the largest |v|, the
spread of the scaled scores (std and largest over the causal pairs) and,
against attention computed in float64 from the same bf16 q, k and v: the
largest error of the port's kernel, of the plain version
(`attention_ref`: float32 scores and p.v, rounded to bf16 at the end), of
that plain version before its bf16 rounding and of
scaled_dot_product_attention; and, for the kernel and the plain version,
the largest ratio of the error to chip_smoke.py's per-call tolerance
(2e-2 + 2e-2 |exact|): above 1 the call would fail against the exact
answer itself.

For the VLM it then runs the first super-block (4 self layers and the
cross layer) in float32, where the flash path reaches the float32 kernel,
and prints for each of its flash calls the largest and the mean error of
the kernel and of the plain version (float32) against float64 attention
on the call's inputs; then the last-token logits of three float32 paths
through that super-block: "flash" (the kernel), "jnp" (the plain
attention) and "flash" with every flash call answered in float64
(`attention_f64`), each pair's largest difference.
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
from repro_torch.kernels.flash_attention import ops, ref  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh_ctx  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.params import init_params  # noqa: E402

TOL = 2e-2


def score_spread(q, k, scale) -> tuple:
    """(std, largest |score|) of the scaled scores over the visible
    pairs, the largest over the batch rows."""
    B, T, H, D = q.shape
    KH = k.shape[2]
    visible = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
    stats = []
    for b in range(B):
        s = torch.einsum("tkgd,skd->kgts",
                         q[b].float().reshape(T, KH, H // KH, D),
                         k[b].float()) * scale
        vis = s[..., visible]
        stats.append((float(vis.std()), float(vis.abs().max())))
    return max(st[0] for st in stats), max(st[1] for st in stats)


def ratio(got, want) -> float:
    """Largest |got - want| / (TOL + TOL |want|)."""
    err = (got.double() - want).abs()
    return float((err / (TOL + TOL * want.abs())).max())


def witness(label, api, params, inputs, mctx) -> None:
    with torch.inference_mode():
        _, calls = cs._recorded_flash(
            lambda: api.prefill(params, inputs, mctx))
    for i, (q, k, v, kw, out) in enumerate(calls):
        scale = kw["scale"] or q.shape[-1] ** -0.5
        want = cs.attention_f64(q, k, v, scale)
        s_std, s_max = score_spread(q, k, scale)
        plain = ref.attention_ref(q, k, v, scale=scale)
        plain32 = ref.attention_ref(q.float(), k.float(), v.float(),
                                    scale=scale)
        lib = F.scaled_dot_product_attention(
            *(x.transpose(1, 2) for x in (q, k, v)), is_causal=True,
            enable_gqa=True, scale=scale).transpose(1, 2)
        errs = {name: float((got.double() - want).abs().max())
                for name, got in (("kernel", out), ("plain", plain),
                                  ("plain f32", plain32), ("sdpa", lib))}
        kern_plain, ok = cs.in_tolerance(out, plain, TOL)
        print(f"{label} call {i}: |v| {v.abs().max().item():.1f}, scores "
              f"std {s_std:.1f} max {s_max:.1f}; max abs error against "
              f"float64: " + ", ".join(f"{n} {e:.4f}" for n, e in
                                       errs.items())
              + f"; error / tolerance: kernel {ratio(out, want):.3f}, plain "
              f"{ratio(plain, want):.3f}; kernel vs plain {kern_plain:.4f} "
              f"{'within' if ok else 'OUTSIDE'} {TOL}", flush=True)
        del want, plain, plain32, lib


def f32_super_block(api, params, inputs, mctx) -> None:
    """The float32 flash calls of the VLM's first super-block against
    float64, the plain version beside them, and the logits of three paths
    through it."""
    block = api.cfg.replace(n_layers=api.cfg.vlm.cross_every,
                            compute_dtype="float32")
    bparams = dict(params, super=cs.first_layers(params["super"], 1))
    flash = ModelAPI(block)
    with torch.inference_mode():
        fl, calls = cs._recorded_flash(
            lambda: flash.prefill(bparams, inputs, mctx)[0])
        for i, (q, k, v, kw, out) in enumerate(calls):
            scale = kw["scale"] or q.shape[-1] ** -0.5
            want = cs.attention_f64(q, k, v, scale)
            plain = ref.attention_ref(q, k, v, scale=scale)
            errs = {name: (got.double() - want).abs()
                    for name, got in (("kernel", out), ("plain", plain))}
            closer = bool(errs["kernel"].max() <= errs["plain"].max())
            print(f"{cs.VLM} float32 super-block call {i}: |v| "
                  f"{v.abs().max().item():.1f}; error against float64: "
                  + ", ".join(f"{n} max {e.max().item():.6f} mean "
                              f"{e.mean().item():.3e}" for n, e in
                              errs.items())
                  + f"; kernel vs plain max "
                  f"{(out - plain).abs().max().item():.6f}; kernel "
                  f"{'at most' if closer else 'MORE than'} the plain "
                  "version's largest error", flush=True)
            del want, plain, errs
        del calls
        pl = ModelAPI(block.replace(attn_impl="jnp")).prefill(
            bparams, inputs, mctx)[0]
        kernel_path = ops.flash_attention   # layers.attention looks it up
        ops.flash_attention = lambda q, k, v, scale=None, **kw: \
            cs.attention_f64(q, k, v, scale or q.shape[-1] ** -0.5).to(
                q.dtype)
        try:
            ex = flash.prefill(bparams, inputs, mctx)[0]
        finally:
            ops.flash_attention = kernel_path
    print(f"{cs.VLM} float32 super-block logits (scale "
          f"{pl.abs().max().item():.3f}), largest difference: flash vs jnp "
          f"{(fl - pl).abs().max().item():.3e}, flash vs float64 attention "
          f"{(fl - ex).abs().max().item():.3e}, jnp vs float64 attention "
          f"{(pl - ex).abs().max().item():.3e}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    print(cs.card_line())
    for arch in ("dbrx-132b", cs.VLM):
        torch.cuda.empty_cache()
        full = get_config(arch)
        layers = (cs.MOE_SERVE[arch] if arch in cs.MOE_SERVE else
                  cs.VLM_SUPER_BLOCKS * full.vlm.cross_every)
        cfg = full.replace(n_layers=layers, attn_impl="flash")
        api = ModelAPI(cfg)
        mctx = make_host_mesh_ctx(cfg)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        params = init_params(api.param_defs(), gen,
                             getattr(torch, cfg.param_dtype))
        rng = np.random.default_rng(args.seed)   # the store's first wave
        tokens = torch.from_numpy(np.stack([
            rng.integers(0, cfg.vocab, cs.SERVE_PLEN, dtype=np.int32)
            for _ in range(cs.SERVE_BATCH)]))
        inputs = {"tokens": tokens}
        if cfg.family == "vlm":
            g2 = torch.Generator(device="cuda").manual_seed(args.seed + 1)
            cross = params["super"]["cross"]
            for key in ("gate_attn", "gate_mlp"):
                mag = 0.5 + torch.rand(cross[key].shape, generator=g2,
                                       device="cuda")
                sign = torch.rand(cross[key].shape, generator=g2,
                                  device="cuda")
                cross[key].copy_(torch.where(sign < 0.5, -mag, mag))
            inputs["vision_embeds"] = torch.randn(
                (cs.SERVE_BATCH, cfg.vlm.n_vision_tokens, cfg.vlm.d_vision),
                generator=g2, device="cuda")
        witness(arch, api, params, inputs, mctx)
        if cfg.family == "vlm":
            f32_super_block(api, params, inputs, mctx)
        del params
    return 0


if __name__ == "__main__":
    sys.exit(main())
