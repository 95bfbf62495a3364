"""Multi-pod dry-run: trace every (arch x shape x mesh) cell, the
counterpart of `repro/launch/dryrun.py`.

The reference lowers and compiles each cell's jitted step on 512 host
placeholder devices and reads XLA's cost and memory analyses and the
collectives of its HLO. The port traces instead: the step's body
(`StaticStep.trace`) runs once under FakeTensorMode on abstract params,
moments and inputs, as rank 0 of a DeviceMesh over torch's fake process
group ("fake" backend, `FakeStore`) of 256 or 512 ranks, and
`roofline/collectives.py` records what it dispatches. Nothing is
allocated and nothing runs: the model kernels pass through their ops'
fake implementations, so no card is needed (a trace is no CPU fallback).
The fake tensors claim `device.trace_device()`: the card where torch is
built for CUDA, "meta" otherwise.

The record keeps the reference's keys, but:
- `lower_s` and `compile_s` become one `trace_s`;
- `flops_per_device` counts matrix products and the kernels' registered
  formulas (elementwise ops count 0), every loop iteration included;
- `bytes_per_device` is computed from every op's inputs and outputs, not
  measured (`bytes_per_device_source` says so);
- `memory` is one rank's live fake storages: arguments, outputs, temps,
  peak.
The process group is global, so a dry-run runs in a process of its own.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
Results are cached as JSON under results/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import dataclasses as _dc
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.common.config import (SHAPES, SHAPE_BY_NAME, ShapeConfig,
                                       TrainConfig, cell_is_runnable)
from repro_torch.configs import ARCHS, get_config
from repro_torch.device import trace_device
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.api import ModelAPI, shardings_for
from repro_torch.models.context import MeshCtx, make_rules
from repro_torch.models.params import abstract, abstract_params, zero1_pspecs
from repro_torch.roofline.collectives import (collective_bytes,
                                              collective_count, count_step)
from repro_torch.train.optimizer import abstract_adam
from repro_torch.train.trainer import (jit_decode_step, jit_prefill_step,
                                       jit_train_step, map_tree, placed)

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

# The reference's microbatch counts (repro/launch/dryrun.py:39-50). Value
# must divide 256 and keep per-microbatch batch divisible by dp (16 or 32).
TRAIN_MICROBATCHES = {
    "gemma-7b": 8,
    "nemotron-4-15b": 16,
    "qwen3-14b": 16,
    "granite-3-2b": 16,
    "llama-3.2-vision-90b": 16,
    "recurrentgemma-2b": 8,
    "whisper-tiny": 4,
    "dbrx-132b": 16,
    "deepseek-v2-236b": 16,
    "rwkv6-1.6b": 8,
}

# The reference's perf variants: config transforms measured against the
# same cell's baseline. Combine with "+".
VARIANTS = {
    "save-coll": lambda c: c.replace(remat_policy="save_collectives"),
    "fp8-dispatch": lambda c: c.replace(
        moe=_dc.replace(c.moe, dispatch_dtype="float8_e4m3fn")),
    "kv-fp8": lambda c: c.replace(kv_cache_dtype="float8_e4m3fn"),
    "cache-seq-shard": lambda c: c.replace(cache_seq_shard=True),
    "no-remat": lambda c: c.replace(remat=False),
    "donate": lambda c: c,          # handled in run_cell (step-level knob)
    "accum-bf16": lambda c: c,      # handled in run_cell (TrainConfig knob)
    "params-bf16": lambda c: c.replace(param_dtype="bfloat16"),
}

# The port's card path: attention through the flash kernels (and the
# hybrid and ssm families' scans through rglru_scan and wkv6), as
# chip_smoke.py drives every family; the configs' own default is the
# plain path.
ATTN_IMPL = "flash"

BYTES_SOURCE = ("computed: the bytes of every op's tensor inputs and outputs "
                "in the trace (views and allocations 0), not measured")


def apply_variant(cfg, variant: str):
    """Returns (cfg, nmb_override). Variant "a+b" composes; "nmbN" sets
    the microbatch count."""
    nmb = None
    if not variant:
        return cfg, nmb
    for v in variant.split("+"):
        if v.startswith("nmb"):
            nmb = int(v[3:])
        else:
            cfg = VARIANTS[v](cfg)
    return cfg, nmb


def cell_path(arch: str, shape: str, multi_pod: bool,
              variant: str = "") -> Path:
    mesh = "2x16x16" if multi_pod else "16x16"
    suffix = f"__{variant}" if variant else ""
    return RESULTS / f"{arch}__{shape}__{mesh}{suffix}.json"


def fake_mesh(shape: Sequence[int], axis_names: Sequence[str]):
    """A DeviceMesh of `shape` on "cuda" over torch's fake process group,
    as its rank 0. The group is the process's default one: another group
    there (of another size or backend) is destroyed first."""
    from torch.distributed.device_mesh import init_device_mesh
    # importing fake_pg registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(shape)
    if dist.is_initialized() and (dist.get_world_size() != n
                                  or dist.get_backend() != "fake"):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", rank=0, world_size=n,
                                store=FakeStore())
    return init_device_mesh("cuda", tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def make_step(api: ModelAPI, mctx: MeshCtx, shape: ShapeConfig,
              nmb: int = 1, accum_dtype: str = "float32",
              donate: bool = False):
    """The jit step of `shape.kind` that a cell traces: the train step
    with donation, nmb microbatches and its accumulator dtype; prefill;
    decode, donating its cache with `donate`."""
    if shape.kind == "train":
        tcfg = TrainConfig(num_microbatches=nmb, accum_dtype=accum_dtype)
        return jit_train_step(api, tcfg, mctx, shape, donate=True)
    if shape.kind == "prefill":
        return jit_prefill_step(api, mctx, shape)
    return jit_decode_step(api, mctx, shape, donate=donate)


def step_args(kind: str, params, opt, inputs) -> tuple:
    """A step's arguments in its order: train (params, opt_state, batch),
    prefill (params, inputs), decode (params, token, pos, cache)."""
    if kind == "train":
        return params, opt, inputs
    if kind == "prefill":
        return params, inputs
    return params, inputs["token"], inputs["pos"], inputs["cache"]


def abstract_args(api: ModelAPI, mctx: MeshCtx, shape: ShapeConfig,
                  device=None) -> tuple:
    """The step's arguments with nothing allocated (under
    FakeTensorMode): params in cfg.param_dtype, the AdamW state of a train
    step (the moments at `zero1_pspecs` with cfg.zero1), and the inputs of
    `api.input_specs(shape)`; on a mesh each at its spec."""
    cfg, mesh = api.cfg, mctx.device_mesh
    defs = api.param_defs()
    params = abstract_params(defs, getattr(torch, cfg.param_dtype), device,
                             mesh, mctx.rules)
    specs = api.input_specs(shape)
    if mesh is None:
        inputs = map_tree(lambda c: abstract(c.shape, c.dtype, device), specs)
    else:
        fitted = shardings_for(mesh, specs, api.input_pspecs(mctx, shape))
        inputs = map_tree(lambda c, s: abstract(c.shape, c.dtype, device,
                                                mesh, s), specs, fitted)
    opt = None
    if shape.kind == "train":
        opt = abstract_adam(params, zero1_pspecs(defs, mesh, mctx.rules)
                            if mesh is not None and cfg.zero1 else None)
    return step_args(shape.kind, params, opt, inputs)


def record_step(step, args) -> dict:
    """The counts of one run of `step`'s body on `args` (placed as a call
    places them, outside the counts): under FakeTensorMode the dry-run's
    record, on real tensors the same counts of the step run eagerly."""
    args = placed(step, *args)
    t0 = time.perf_counter()
    c = count_step(getattr(step, "step", step).trace, *args)
    trace_s = time.perf_counter() - t0
    cbytes, ckinds = collective_bytes(c.collectives)
    return {"flops_per_device": float(c.flops),
            "flops_by_op": c.flops_by_op,
            "bytes_per_device": float(c.bytes_accessed),
            "bytes_per_device_source": BYTES_SOURCE,
            "collective_bytes_per_device": int(cbytes),
            "collective_breakdown": ckinds,
            "collective_counts": collective_count(c.collectives),
            "memory": c.memory, "trace_s": round(trace_s, 1)}


def trace_cell(cfg, shape: ShapeConfig, mesh_shape=None,
               nmb: Optional[int] = None, accum_dtype: str = "float32",
               donate: bool = False) -> dict:
    """One cell's record fields: `cfg`'s step at `shape` traced under
    FakeTensorMode, on a fake mesh of `mesh_shape` (a MeshShape; None: one
    device, no process group). nmb None takes cfg's TRAIN_MICROBATCHES,
    halved until each microbatch shards over all the data ways."""
    mesh = None if mesh_shape is None else fake_mesh(mesh_shape.shape,
                                                    mesh_shape.axis_names)
    with FakeTensorMode(allow_non_fake_inputs=False):
        device = trace_device()
        api = ModelAPI(cfg, device)
        mctx = MeshCtx(device=device, mesh=mesh, rules=make_rules(cfg))
        if shape.kind == "train" and nmb is None:
            nmb = TRAIN_MICROBATCHES.get(cfg.name, 8)
            dp = mctx.dp_size()
            while nmb > 1 and (shape.global_batch // nmb) % dp != 0:
                nmb //= 2
        step = make_step(api, mctx, shape, nmb or 1, accum_dtype, donate)
        rec = record_step(step, abstract_args(api, mctx, shape, device))
    rec.update({"n_devices": 1 if mesh is None else mesh.size(),
                "num_microbatches": nmb, "trace_device": str(device)})
    return rec


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             variant: str = "") -> dict:
    shape = SHAPE_BY_NAME[shape_name]
    cfg = get_config(arch).replace(attn_impl=ATTN_IMPL)
    cfg, nmb_override = apply_variant(cfg, variant)
    parts = variant.split("+") if variant else []
    rec = trace_cell(cfg, shape, production_mesh_shape(multi_pod=multi_pod),
                     nmb_override,
                     "bfloat16" if "accum-bf16" in parts else "float32",
                     "donate" in parts)
    return {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "variant": variant, "attn_impl": cfg.attn_impl,
        "kind": shape.kind,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        **rec,
        "n_params": int(cfg.n_params()),
        "n_active_params": int(cfg.n_active_params()),
        "ok": True,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="",
                    help="perf variant(s), e.g. save-coll+nmb4")
    args = ap.parse_args()

    RESULTS.mkdir(parents=True, exist_ok=True)
    cells = []
    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in SHAPES]
    meshes = [args.multi_pod] if (args.multi_pod or not args.all) else [False, True]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                cells.append((a, s, mp))

    failures = 0
    for arch, shape, mp in cells:
        path = cell_path(arch, shape, mp, args.variant)
        if path.exists() and not args.force:
            print(f"[skip-cached] {path.name}")
            continue
        if not cell_is_runnable(arch, shape):
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16", "ok": True,
                   "skipped": "full-attention arch; long_500k requires "
                              "sub-quadratic sequence mixing"}
            path.write_text(json.dumps(rec, indent=1))
            print(f"[skip-quad ] {path.name}")
            continue
        print(f"[trace] {arch} x {shape} x "
              f"{'2x16x16' if mp else '16x16'}"
              f"{' x ' + args.variant if args.variant else ''} ...",
              flush=True)
        try:
            rec = run_cell(arch, shape, mp, args.variant)
            path.write_text(json.dumps(rec, indent=1))
            print(f"  ok: flops/dev={rec['flops_per_device']:.3e} "
                  f"coll/dev={rec['collective_bytes_per_device']:.3e} "
                  f"peak={rec['memory']['peak_memory_in_bytes']:.3e} B "
                  f"trace={rec['trace_s']}s", flush=True)
        except Exception as e:  # noqa
            failures += 1
            rec = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16",
                   "ok": False, "error": "".join(
                       traceback.format_exception_only(type(e), e))[-2000:]}
            path.write_text(json.dumps(rec, indent=1))
            print(f"  FAIL: {rec['error'][:300]}", flush=True)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
