"""Quickstart on the PyTorch port: train a tiny LM whose data and
checkpoints flow through the ROS2 RDMA-first, SmartNIC-offloaded object
store, on the CUDA card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The counterpart of `examples/quickstart.py`, through `repro_torch` entry
points only: build a client (DPU-offloaded DFS over RDMA), write token
shards into the replicated object store, stream batches through the data
plane, train through the compiled step (`jit_train_step`, where the
reference uses `jax.jit`), checkpoint asynchronously, and print the
transport counters that show the host stayed off the data path.
"""
import argparse

import torch

from repro_torch.common.config import ShapeConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.client import ROS2Client
from repro_torch.data.pipeline import ROS2TokenLoader, write_token_shards
from repro_torch.distributed.checkpoint import ROS2CheckpointManager
from repro_torch.launch.mesh import make_host_mesh_ctx
from repro_torch.launch.train import synth_tokens
from repro_torch.models.api import ModelAPI
from repro_torch.models.params import init_params
from repro_torch.train.optimizer import init_adam
from repro_torch.train.trainer import jit_train_step

STEPS, BATCH, SEQ = 20, 4, 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the CUDA card by default, or cpu")
    args = ap.parse_args(argv)

    # 1. the storage system: DFS client offloaded to the (simulated)
    #    BlueField-3, RDMA data plane, 4-SSD replicated DAOS-style store
    client = ROS2Client(mode="dpu", transport="rdma", n_devices=4,
                        device=args.device)

    # 2. model + data (a learnable bigram corpus)
    cfg = get_config("tiny-gemma-7b")
    api = ModelAPI(cfg, device=args.device)
    mctx = make_host_mesh_ctx(cfg, device=args.device)
    corpus = synth_tokens(cfg.vocab, (STEPS + 2) * BATCH * (SEQ + 1))
    write_token_shards(client, "/data", corpus)
    loader = ROS2TokenLoader(client, "/data", global_batch=BATCH,
                             seq_len=SEQ, prefetch=2)

    # 3. train through the compiled step, checkpointing through the same
    #    object store. The reference's TrainConfig(lr=1e-3) warms up over
    #    100 steps, so in these 20 its loss wanders around ln(vocab) by
    #    noise; warmed up over 2 steps to 1e-2 it falls.
    step = jit_train_step(api, TrainConfig(lr=1e-2, warmup_steps=2,
                                           total_steps=STEPS), mctx,
                          ShapeConfig("train", SEQ, BATCH, "train"))
    gen = torch.Generator(device=mctx.device).manual_seed(0)
    params = init_params(api.param_defs(), gen,
                         getattr(torch, cfg.param_dtype), mctx.device)
    opt = init_adam(params)
    ckpt = ROS2CheckpointManager(client, "/ckpt")
    losses = []
    for i in range(STEPS):
        params, opt, m = step(params, opt, loader.next_batch())
        losses.append(float(m["loss"]))
        last = losses[-1]
        if (i + 1) % 10 == 0:
            ckpt.save(i + 1, {"params": params, "opt": opt})
            print(f"step {i + 1:3d}  loss {last:.4f}  (checkpoint async)")
    ckpt.wait()

    # 4. what the paper is about: the data path never touched the host CPU
    first = losses[0]
    print(f"\nloss: {first:.4f} -> {last:.4f}")
    print(f"DPU ops processed on the SmartNIC: {client.dpu.ops_processed}")
    s = client.io.stats
    print(f"data plane: {s.bytes_moved / 1e6:.1f} MB moved, "
          f"{s.copy_bytes / max(s.bytes_moved, 1):.2f} copies/byte "
          f"(RDMA zero-copy), {s.rendezvous} rendezvous / {s.eager} eager")
    print(f"control plane: {client.control.rpc_count} RPCs, "
          f"{client.control.rpc_bytes / 1e3:.1f} kB (tiny, by design)")
    print(f"restore works: step {ckpt.latest_step()} committed")
    loader.close()
    client.close()
    assert last < first
    assert sum(losses[-5:]) < sum(losses[:5])      # the trend, not noise
    return losses


if __name__ == "__main__":
    main()
