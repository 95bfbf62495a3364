"""One rank of the port's multi-device parity checks (no JAX here).

    python tests/_torch_mesh_worker.py CASE RANK WORLD STORE IN OUT

joins a gloo group of WORLD ranks through the FileStore at STORE, runs
CASE on the inputs pickled at IN (numpy arrays made by the test from the
reference) and pickles this rank's results to OUT.RANK. One torch thread
a rank. `tests/test_torch_multidevice.py` starts the ranks, each under a
time limit, and compares their results with the reference's.
"""
import dataclasses
import pickle
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.common.config import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.configs import tiny_config  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh_ctx  # noqa: E402
from repro_torch.models.api import ModelAPI  # noqa: E402
from repro_torch.models.context import make_mesh, mesh_ctx  # noqa: E402
from repro_torch.models.params import (params_from_numpy,  # noqa: E402
                                       params_to_numpy, tree_map)
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train.trainer import (jit_decode_step,  # noqa: E402
                                       jit_prefill_step, jit_train_step)


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


def train(job, rank):
    """From each of the reference's states, one jit_train_step on the
    (data, model) mesh: loss, grad norm, the params and moments after it
    (whole), and this rank's moment shards with their placements."""
    cfg = _cfg(job["cfg"])
    mctx = make_host_mesh_ctx(cfg, *job["mesh"], device="cpu")
    api = ModelAPI(cfg, device="cpu")
    tcfg = TrainConfig(**job["tcfg"])
    shape = ShapeConfig("t", job["seq"], job["batch"], "train")
    out = []
    for state, batch in zip(job["states"], job["batches"]):
        step = jit_train_step(api, tcfg, mctx, shape)
        params = params_from_numpy(state["params"], device="cpu")
        adam = opt.AdamState(torch.tensor(state["step"], dtype=torch.int32),
                             params_from_numpy(state["m"], device="cpu"),
                             params_from_numpy(state["v"], device="cpu"))
        params, adam, metrics = step(params, adam, batch)
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
    """jit_prefill_step, then decode steps through jit_decode_step, on the
    (data, model) mesh: the logits (whole) and the cache's placements."""
    cfg = _cfg(job["cfg"])
    mctx = make_host_mesh_ctx(cfg, *job["mesh"], device="cpu")
    api = ModelAPI(cfg, device="cpu")
    params = params_from_numpy(job["params"], device="cpu")
    toks = job["tokens"]
    B, T = toks.shape
    prefill = jit_prefill_step(api, mctx, ShapeConfig("p", T, B, "prefill"))
    logits, cache = prefill(params, {"tokens": toks})
    out = {"prefill": _host(logits),
           "cache_placements": tree_map(_placements, cache)}
    grown = tree_map(lambda c: torch.cat(
        [c.full_tensor(), torch.zeros_like(c.full_tensor())[:, :, :job[
            "grow"]]], dim=2), cache)
    decode = jit_decode_step(api, mctx, ShapeConfig(
        "d", T + job["grow"], B, "decode"))
    steps = []
    for token, pos in job["decode"]:
        logits, grown = decode(params, token, pos, grown)
        steps.append(_host(logits))
    out["decode"] = steps
    return out


CASES = {"train": train, "moe": moe, "gpipe": gpipe, "serve": serve}


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
