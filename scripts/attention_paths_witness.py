#!/usr/bin/env python3
"""How far the two attention paths of the dense model drift apart at
granite-3-2b's widths, in the JAX reference and in the PyTorch port, on the
CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/attention_paths_witness.py \
        [--layers 2 6] [--batch 2] [--tokens 128] [--seed 0]

granite-3-2b at full width (d_model 2048, 32 heads, 8 kv heads, head_dim
64, d_ff 8192, vocab 49155) is cut to `--layers` layers. The reference's
`init_params` makes the params from `--seed`; the port gets the same
values through `params_from_numpy`. For each depth and compute dtype
(bfloat16, float32) one prefill of `--batch` x `--tokens` seeded tokens
runs with attn_impl "flash" and with "jnp" in both packages: the
reference's flash path is its Pallas kernel in interpret mode, the port's
(on the CPU) the kernel's plain version. Each line printed is a JSON
object with the last-token logits' largest absolute difference between
the two paths, the logit scale (the largest absolute logit of the jnp
path), and in how many rows the first greedy token agrees.

It needs both packages (JAX for the reference), so it is a check, not part
of the port. Keep the depth small: each layer holds 243 MB of float32
params in each package.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def _compare(a: np.ndarray, b: np.ndarray) -> dict:
    a, b = a.astype(np.float64), b.astype(np.float64)
    return {"max_abs_diff": float(np.abs(a - b).max()),
            "logit_scale": float(np.abs(b).max()),
            "first_token_agree": int((a.argmax(-1) == b.argmax(-1)).sum())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 6])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import torch

    from repro.configs import get_config as ref_get_config
    from repro.models.api import ModelAPI as RefAPI
    from repro.models.context import single_device_ctx as ref_ctx
    from repro.models.params import init_params as ref_init_params
    from repro_torch.configs import get_config
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import single_device_ctx
    from repro_torch.models.params import params_from_numpy

    for n_layers in args.layers:
        ref_base = ref_get_config("granite-3-2b").replace(n_layers=n_layers)
        base = get_config("granite-3-2b").replace(n_layers=n_layers)
        ref_params = ref_init_params(RefAPI(ref_base).param_defs(),
                                     jax.random.PRNGKey(args.seed))
        params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
        toks = np.random.default_rng(args.seed).integers(
            0, base.vocab, (args.batch, args.tokens), dtype=np.int32)
        for dtype in ("bfloat16", "float32"):
            ref_logits, logits = {}, {}
            for impl in ("flash", "jnp"):
                ref_cfg = ref_base.replace(attn_impl=impl, compute_dtype=dtype)
                api, mctx = RefAPI(ref_cfg), ref_ctx(ref_cfg)
                lg, _ = jax.jit(lambda p, t: api.prefill(
                    p, {"tokens": t}, mctx))(ref_params, toks)
                ref_logits[impl] = np.asarray(lg.astype(np.float32))
                cfg = base.replace(attn_impl=impl, compute_dtype=dtype)
                tapi = ModelAPI(cfg, device="cpu")
                with torch.inference_mode():
                    lg, _ = tapi.prefill(params, {"tokens": torch.from_numpy(
                        toks)}, single_device_ctx(cfg, device="cpu"))
                logits[impl] = lg.float().numpy()
            print(json.dumps({
                "layers": n_layers, "compute_dtype": dtype,
                "batch": args.batch, "tokens": args.tokens,
                "seed": args.seed,
                "reference_flash_vs_jnp": _compare(ref_logits["flash"],
                                                   ref_logits["jnp"]),
                "port_flash_vs_jnp": _compare(logits["flash"], logits["jnp"]),
                "port_vs_reference_jnp": _compare(logits["jnp"],
                                                  ref_logits["jnp"]),
                "port_vs_reference_flash": _compare(logits["flash"],
                                                    ref_logits["flash"])}),
                flush=True)
        del ref_params, params
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
