"""End-to-end training: the paper's storage stack feeding a PyTorch
training loop on the CUDA card, the counterpart of `repro/launch/train.py`.

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch dense-100m --steps 30 --global-batch 8 --seq 256 \
        --microbatches 2 --storage-mode dpu --transport rdma --ckpt-every 10

The storage path is the real (functional) ROS2 system: token shards are
written into the replicated object store through the DFS client (host or
DPU-offloaded), the loader streams batches over the RDMA/TCP data plane
with prefetch + hedged reads, and checkpoints flow back asynchronously.
The model, its params and its optimizer state live on the card; each
step's batch goes to the card once, into the static batch buffers of the
compiled step (`jit_train_step`: captured once into a CUDA graph and
replayed every step, the params and moments updated in place). The
checkpoint writer snapshots those tensors between replays, and `--resume`
copies the restored state into them. It runs on the card unless
`--device cpu` asks for the CPU; without a card and that flag it raises.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.common.config import ShapeConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.client import ROS2Client
from repro_torch.data.pipeline import ROS2TokenLoader, write_token_shards
from repro_torch.distributed.checkpoint import ROS2CheckpointManager
from repro_torch.distributed.fault import FailureInjector, StragglerMonitor
from repro_torch.launch.mesh import make_host_mesh_ctx
from repro_torch.models.api import ModelAPI
from repro_torch.models.params import (init_params, params_from_numpy,
                                       tree_map)
from repro_torch.train.optimizer import AdamState, init_adam
from repro_torch.train.trainer import jit_train_step


def synth_tokens(vocab: int, n: int, seed: int = 0) -> np.ndarray:
    """Synthetic corpus with learnable bigram structure (loss can drop)."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab, (vocab, 4))
    toks = np.empty(n, np.int32)
    toks[0] = rng.integers(vocab)
    choice = rng.integers(0, 4, n)
    for i in range(1, n):
        toks[i] = trans[toks[i - 1], choice[i]]
    return toks


def build(args):
    cfg = get_config(args.arch)
    api = ModelAPI(cfg, device=args.device)
    mctx = make_host_mesh_ctx(cfg, device=args.device)
    client = ROS2Client(mode=args.storage_mode, transport=args.transport,
                        n_devices=args.n_ssd,
                        inline_encryption=args.encrypt, device=args.device)
    return cfg, api, mctx, client


def state_from_numpy(state, device) -> tuple:
    """(params, AdamState) as tensors on `device` from a restored
    checkpoint's numpy tree {"params": ..., "opt": AdamState(...)}."""
    opt = state["opt"]
    return (params_from_numpy(state["params"], device),
            AdamState(step=torch.tensor(np.array(opt.step), device=device),
                      m=params_from_numpy(opt.m, device),
                      v=params_from_numpy(opt.v, device)))


@torch.no_grad()
def restore_into(params, opt: AdamState, state) -> None:
    """A restored checkpoint's state copied into `params` and `opt` in
    place (the compiled step's own tensors), not rebound."""
    new_params, new_opt = state_from_numpy(state, opt.step.device)
    for dst, src in ((params, new_params), (opt.m, new_opt.m),
                     (opt.v, new_opt.v)):
        tree_map(lambda d, s: d.copy_(s), dst, src)
    opt.step.copy_(new_opt.step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-gemma-7b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--storage-mode", choices=("host", "dpu"), default="dpu")
    ap.add_argument("--transport", choices=("tcp", "rdma"), default="rdma")
    ap.add_argument("--encrypt", action="store_true")
    ap.add_argument("--n-ssd", type=int, default=4)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=-1,
                    help="kill a storage device at this step (drill)")
    ap.add_argument("--tokens", type=int, default=0,
                    help="corpus size (default: enough for the run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="where the model runs: the CUDA card by default, "
                         "or cpu")
    args = ap.parse_args(argv)

    cfg, api, mctx, client = build(args)
    dev = mctx.device
    need = args.tokens or (args.steps * args.global_batch
                           * (args.seq + 1) + args.seq + 1)
    print(f"[train] arch={cfg.name} params={cfg.n_params():,} "
          f"storage={args.storage_mode}/{args.transport} corpus={need:,} tok")
    write_token_shards(client, "/data", synth_tokens(cfg.vocab, need,
                                                     args.seed))
    loader = ROS2TokenLoader(client, "/data", global_batch=args.global_batch,
                             seq_len=args.seq, prefetch=2,
                             hedge_timeout_s=0.5)
    tcfg = TrainConfig(lr=args.lr, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       num_microbatches=args.microbatches)
    step_fn = jit_train_step(api, tcfg, mctx, ShapeConfig(
        "train", args.seq, args.global_batch, "train"))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(api.param_defs(), gen,
                         getattr(torch, cfg.param_dtype), dev)
    opt = init_adam(params)

    ckpt = ROS2CheckpointManager(client, "/ckpt", keep=2)
    start = 0
    if args.resume:
        s, state = ckpt.restore({"params": params, "opt": opt})
        if s is not None:
            restore_into(params, opt, state)
            start = s
            print(f"[train] resumed from step {s}")

    mon = StragglerMonitor()
    injector = FailureInjector(client.store)
    t_run = time.time()
    tokens_done = 0
    for step in range(start, args.steps):
        if step == args.inject_failure_at:
            victim = client.devices[0].name
            injector.kill(victim)
            print(f"[drill] killed storage device {victim}; reads now come "
                  f"from replicas")
        t0 = time.time()
        params, opt, metrics = step_fn(params, opt, loader.next_batch())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.time() - t0
        mon.record(0, dt)
        tokens_done += args.global_batch * args.seq
        if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt})
        if step < 3 or (step + 1) % 10 == 0:
            print(f"  step {step + 1:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt * 1e3:.0f} ms")
    ckpt.wait()
    wall = time.time() - t_run
    lm = loader.metrics()
    print(f"[train] done: {tokens_done / wall:,.0f} tok/s wall={wall:.1f}s "
          f"stall={lm['stall_s']:.2f}s "
          f"({100 * lm['stall_s'] / max(wall, 1e-9):.1f}%) "
          f"hedges={int(lm['hedges_issued'])}")
    if client.dpu:
        print(f"[train] DPU ops processed: {client.dpu.ops_processed} "
              f"(host stayed off the data path)")
    loader.close()
    client.close()
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
