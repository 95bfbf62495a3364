#!/usr/bin/env python3
"""Loss of the reference and of the PyTorch port, step by step, on the
data of launch/train.py: dense-100m's widths cut in depth, the flags of
examples/train_100m_ros2.py (global batch 8, seq 256, 2 microbatches, lr
1e-3, warmup steps // 10), the same params (the reference's init, carried
across) and the same batches of `synth_tokens`, on the CPU with the plain
attention path.

    PYTHONPATH=src python tools/train_loss_witness.py --layers 6 --steps 30

It prints each step's loss and grad norm in both packages and the mean of
the first and the last 5 losses. It shows whether the loss can fall in
the run `chip_smoke.py` makes: with the reference's fan-in init
(`repro/models/params.py`) the gradient norm grows with depth, and the
loss of the deeper model stays flat in both packages. Needs JAX and a few
GB of memory; at full depth it is a full-size run, for a larger machine.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax
    import torch
    from repro.common.config import TrainConfig as RefTrainConfig
    from repro.configs import get_config as ref_get_config
    from repro.data.pipeline import Assignment
    from repro.launch.train import synth_tokens
    from repro.models.api import ModelAPI as RefAPI
    from repro.models.context import single_device_ctx as ref_ctx
    from repro.models.params import init_params as ref_init_params
    from repro.train.optimizer import init_adam as ref_init_adam
    from repro.train.trainer import make_train_step as ref_make_train_step
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.models.api import ModelAPI
    from repro_torch.models.context import single_device_ctx
    from repro_torch.models.params import params_from_numpy
    from repro_torch.train.optimizer import init_adam
    from repro_torch.train.trainer import make_train_step

    gb, seq, steps = 8, 256, args.steps
    over = dict(n_layers=args.layers, compute_dtype=args.compute_dtype)
    ref_cfg = ref_get_config("dense-100m").replace(**over)
    cfg = get_config("dense-100m").replace(**over)
    need = steps * gb * (seq + 1) + seq + 1
    tokens = synth_tokens(cfg.vocab, need, args.seed)
    asg = Assignment(need // (seq + 1), gb, 0, 1, args.seed, 0)
    kw = dict(lr=1e-3, total_steps=steps, warmup_steps=max(1, steps // 10),
              num_microbatches=2)
    ref_api, api = RefAPI(ref_cfg), ModelAPI(cfg, device="cpu")
    rp = ref_init_params(ref_api.param_defs(), jax.random.PRNGKey(args.seed))
    p = params_from_numpy(jax.tree.map(np.asarray, rp), device="cpu")
    ro, o = ref_init_adam(rp), init_adam(p)
    ref_step = jax.jit(ref_make_train_step(ref_api, RefTrainConfig(**kw),
                                           ref_ctx(ref_cfg)))
    step = make_train_step(api, TrainConfig(**kw),
                           single_device_ctx(cfg, device="cpu"))
    ref_losses, losses = [], []
    for i in range(steps):
        rows = np.stack([tokens[j * (seq + 1):(j + 1) * (seq + 1)]
                         for j in asg.samples_for_step(i)])
        batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
        rp, ro, rm = ref_step(rp, ro, batch)
        p, o, m = step(p, o, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        ref_losses.append(float(rm["loss"]))
        losses.append(float(m["loss"]))
        print(f"step {i + 1:3d}  reference loss {ref_losses[-1]:.5f} grad "
              f"norm {float(rm['grad_norm']):.4g}  port loss {losses[-1]:.5f}"
              f" grad norm {float(m['grad_norm']):.4g}", flush=True)
    for name, ls in (("reference", ref_losses), ("port", losses)):
        print(f"{name}: {args.layers} layers, first 5 mean "
              f"{np.mean(ls[:5]):.5f}, last 5 mean {np.mean(ls[-5:]):.5f}")


if __name__ == "__main__":
    main()
