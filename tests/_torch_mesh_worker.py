"""One rank of the port's multi-device parity checks (no JAX here).

    python tests/_torch_mesh_worker.py CASE RANK WORLD STORE IN OUT

joins a gloo group of WORLD ranks through the FileStore at STORE, runs
CASE on the inputs pickled at IN (numpy arrays made by the test from the
reference) and pickles this rank's results to OUT.RANK. One torch thread
a rank. `tests/test_torch_multidevice.py`,
`tests/test_torch_tensor_parallel.py` and
`tests/test_torch_tensor_parallel_families.py` start the ranks, each
launch under a time limit, and compare their results with the
reference's.
"""
import contextlib
import dataclasses
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch._C._distributed_c10d import ProcessGroup
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.common.config import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs import tiny_config  # noqa: E402
from repro_torch.launch.serve import grow_cache  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh_ctx  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.context import make_mesh, mesh_ctx  # noqa: E402
from repro_torch.models.params import (_leaves,  # noqa: E402
                                       params_from_numpy, params_to_numpy,
                                       tree_map)
from repro_torch.roofline.collectives import (collective_count,  # noqa: E402
                                              count_step)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import (jit_decode_step,  # noqa: E402
                                       jit_prefill_step, jit_train_step,
                                       placed)


def _cfg(spec: dict):
    cfg = tiny_config(spec["name"]).replace(**spec.get("over", {}))
    if spec.get("moe"):
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **spec["moe"]))
    return cfg


def _host(t):
    """A DTensor's or tensor's whole value as numpy (bf16 as ml_dtypes)."""
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    return params_to_numpy({"x": t})["x"]


def _placements(t):
    return [("S", p.dim) if p.is_shard() else ("R",) for p in t.placements]


def _state(state: dict):
    """The params and AdamState of one of the reference's states."""
    return (params_from_numpy(state["params"], device="cpu"),
            opt.AdamState(torch.tensor(state["step"], dtype=torch.int32),
                          params_from_numpy(state["m"], device="cpu"),
                          params_from_numpy(state["v"], device="cpu")))


def train(job, rank, during=contextlib.nullcontext):
    """From each of the reference's states, one jit_train_step on the
    (data, model) mesh, run inside `during()` (given the params it
    returns): loss, grad norm, the params and moments after it (whole),
    and this rank's moment shards with their placements."""
    cfg = _cfg(job["cfg"])
    mctx = make_host_mesh_ctx(cfg, *job["mesh"], device="cpu")
    api = ModelAPI(cfg, device="cpu")
    tcfg = TrainConfig(**job["tcfg"])
    shape = ShapeConfig("t", job["seq"], job["batch"], "train")
    out = []
    for state, batch in zip(job["states"], job["batches"]):
        step = jit_train_step(api, tcfg, mctx, shape)
        params, adam = _state(state)
        with during() as stepped:
            params, adam, metrics = step(params, adam, batch)
            if stepped is not None:
                stepped.append(params)
        out.append({
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "lr": float(metrics["lr"]),
            "step": int(adam.step),
            "params": tree_map(_host, params),
            "m": tree_map(_host, adam.m), "v": tree_map(_host, adam.v),
            "m_local": tree_map(lambda t: t.to_local().numpy().copy(),
                                adam.m),
            "m_placements": tree_map(_placements, adam.m),
            "p_placements": tree_map(_placements, params),
            "coordinate": list(mctx.device_mesh.get_coordinate())})
    return out


def moe(job, rank):
    """moe_ffn on each mesh and case, this rank's block of the batch; the
    bytes each exchange sent and received."""
    from repro_torch.models import moe as M
    sent = []
    real = M._exchange

    def recorded(x, group):
        y = real(x, group)
        sent.append((x.contiguous().view(torch.uint8).numpy().copy(),
                     y.view(torch.uint8).numpy().copy()))
        return y
    M._exchange = recorded
    out = {}
    for shape in job["meshes"]:
        mesh = make_mesh(shape, ("data", "model"), "cpu")
        for case, c in job["cases"].items():
            cfg = _cfg(c["cfg"])
            mctx = mesh_ctx(cfg, mesh)
            x = torch.from_numpy(c["x"])
            dp = mctx.dp_size()
            if x.shape[0] % dp == 0:
                d = mctx.coordinate("data")
                bl = x.shape[0] // dp
                x = x[d * bl:(d + 1) * bl]
            sent.clear()
            p = tree_map(torch.from_numpy, c["p"])
            y = M.moe_ffn(x, p, cfg, mctx)
            out[(tuple(shape), case)] = {
                "y": y.numpy(), "coordinate": list(mesh.get_coordinate()),
                "wire": list(sent)}
    return out


def gpipe(job, rank):
    """gpipe_forward and gpipe_loss on the (pod, data, model) mesh, with
    the point-to-point operations counted."""
    from repro_torch.distributed import pipeline as PP
    ops = []
    real = dist.batch_isend_irecv

    def counted(p2p):
        ops.extend(op.op.__name__ for op in p2p)
        return real(p2p)
    dist.batch_isend_irecv = counted
    cfg = _cfg(job["cfg"])
    mesh = make_mesh(job["mesh"], ("pod", "data", "model"), "cpu")
    params = params_from_numpy(job["params"], device="cpu")
    toks = torch.from_numpy(job["tokens"])
    with torch.no_grad():
        logits = PP.gpipe_forward(params, toks, cfg, mesh, job["n_micro"])
        n_fwd = len(ops)
        loss = PP.gpipe_loss(params, {"tokens": toks, "labels": toks}, cfg,
                             mesh, job["n_micro"])
    return {"logits": logits.numpy(), "loss": float(loss),
            "ops": ops[:n_fwd], "coordinate": list(mesh.get_coordinate())}


def serve(job, rank):
    """jit_prefill_step on the tokens (with the job's other prefill
    inputs: the vlm's patch embeddings, the encdec's frames, over which
    `seq` is the prefill shape's length), then decode steps through
    jit_decode_step from the cache grown by `grow` positions, on the
    (data, model) mesh: the logits (whole) and the cache's placements."""
    cfg = _cfg(job["cfg"])
    mctx = make_host_mesh_ctx(cfg, *job["mesh"], device="cpu")
    api = ModelAPI(cfg, device="cpu")
    params = params_from_numpy(job["params"], device="cpu")
    toks = job["tokens"]
    B, T = toks.shape
    prefill = jit_prefill_step(api, mctx, ShapeConfig(
        "p", job.get("seq", T), B, "prefill"))
    logits, cache = prefill(params, dict(job.get("inputs", {}), tokens=toks))
    out = {"prefill": _host(logits),
           "cache_placements": tree_map(
               lambda c: None if c is None else _placements(c), cache)}
    grown = grow_cache(tree_map(lambda c: None if c is None
                                else c.full_tensor(), cache),
                       cfg.family, job["grow"])
    decode = jit_decode_step(api, mctx, ShapeConfig(
        "d", T + job["grow"], B, "decode"))
    steps = []
    for token, pos in job["decode"]:
        logits, grown = decode(params, token, pos, grown)
        steps.append(_host(logits))
    out["decode"] = steps
    return out


class _Gathers(TorchDispatchMode):
    """Every all-gather dispatched inside it: its group's ranks, the
    address of its input's storage, its input's and its output's element
    counts."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func._schema.name
        if name == "c10d::_allgather_base_":
            result, src = args[0], args[1]
            ranks = dist.get_process_group_ranks(ProcessGroup.unbox(args[2]))
        elif name == "_c10d_functional::all_gather_into_tensor":
            result, src = out, args[0]
            ranks = dist.get_process_group_ranks(
                _resolve_process_group(args[2]))
        elif "allgather" in name or "all_gather" in name:
            raise AssertionError(f"an all-gather the check does not read: "
                                 f"{name}")
        else:
            return out
        self.seen.append((sorted(ranks), src.untyped_storage().data_ptr(),
                          src.numel(), result.numel()))
        return out


def tp(job, rank):
    """The tensor-parallel step of one config on the (data, model) mesh:
    `train` from each of the reference's states, recording in each step
    every all-gather (`_Gathers`) and DTensor.full_tensor() call, beside
    the storages of the params the step updated; then `serve`'s prefill
    and decode steps."""
    steps = []
    real = DTensor.full_tensor

    @contextlib.contextmanager
    def recorded():
        calls, out = [], []

        def counted(self, *a, **k):
            calls.append(tuple(self.shape))
            return real(self, *a, **k)
        gathers = _Gathers()
        DTensor.full_tensor = counted
        try:
            with gathers:
                yield out
        finally:
            DTensor.full_tensor = real
        storages = {t.to_local().untyped_storage().data_ptr(): (
            "/".join(path), tuple(t.to_local().shape), tuple(t.shape))
            for path, t in _leaves(out[0])}
        steps.append({"gathers": gathers.seen, "storages": storages,
                      "full_tensor_calls": calls})
    return {"train": train(job, rank, recorded), "steps": steps,
            "serve": serve(job["serve"], rank) if "serve" in job else None,
            "policies": policies(job, rank) if job.get("policies") else None}


def policies(job, rank):
    """From the reference's first state, one jit_train_step body under
    each remat policy, run under the dry-run's recorder
    (`roofline.collectives.count_step` on real tensors): its collectives
    by kind, its loss, and the params and moments after it (whole)."""
    cfg = _cfg(job["cfg"])
    mctx = make_host_mesh_ctx(cfg, *job["mesh"], device="cpu")
    tcfg = TrainConfig(**job["tcfg"])
    shape = ShapeConfig("t", job["seq"], job["batch"], "train")
    batch = {k: torch.from_numpy(v) for k, v in job["batches"][0].items()}
    out = {}
    for policy in ("nothing", "save_collectives"):
        api = ModelAPI(cfg.replace(remat_policy=policy), device="cpu")
        step = jit_train_step(api, tcfg, mctx, shape)
        counted = count_step(step.step.trace, *placed(
            step, *_state(job["states"][0]), batch))
        params, adam, metrics = counted.outputs
        out[policy] = {"collectives": collective_count(counted.collectives),
                       "loss": float(metrics["loss"]),
                       "params": tree_map(_host, params),
                       "m": tree_map(_host, adam.m),
                       "v": tree_map(_host, adam.v)}
    return out


CASES = {"train": train, "moe": moe, "gpipe": gpipe, "serve": serve,
         "tp": tp}


def main():
    case, rank, world, store, src, dst = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        with open(src, "rb") as f:
            jobs = pickle.load(f)
        out = [CASES[case](job, rank) for job in jobs]
    finally:
        dist.destroy_process_group()
    with open(f"{dst}.{rank}", "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
