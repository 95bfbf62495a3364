"""The sharded transformer step against the reference, on gloo CPU ranks.

The dense and moe families compute on each rank's local shards: heads,
mlp columns, vocab and experts over "model", fsdp leaves gathered over
"data" a layer at a time (`models/transformer.py`). Each config below
runs on a (data 2, model 2) and a (data 1, model 4) mesh, four ranks as
subprocesses of `tests/_torch_mesh_worker.py` (case "tp", one launch of
every config a mesh, under its time limit), and is held against the
reference's one-device step at `tests/test_torch_train.py`'s tolerances,
from each of the reference's states in turn (three steps, checked after
the first and the third):

- granite: all heads, kv heads and columns divide; tied embeddings, flash;
- nemotron: 12 q heads over 3 kv heads, which do not divide the model
  ranks: every rank projects the kv heads whole and takes those its q
  heads use (in uneven groups on most ranks);
- qwen3: 5 heads, which do not divide: attention replicated, qk-norm;
- gemma: geglu, tied, every head on its own rank at model 4;
- deepseek: MLA, fsdp, shared experts;
- dbrx: fsdp, at capacity factor 4 with the float32 dispatch, as
  `tests/test_torch_multidevice.py` runs it (capacities depend on the
  model ranks, so with drops the two would compute different functions).

Also: granite, nemotron, deepseek and dbrx from the first state under
each remat policy, counted by the dry-run's recorder: "save_collectives"
gives the same state as "nothing" with fewer collectives in the
backward's recompute; prefill and two decode steps of each config on
both meshes at the multi-device tests' 1e-4; a structure check of every step (no
`full_tensor()`, no all-gather of a param's shard over "model", and an
all-gather of a param's shard over "data" only of one layer of it); and
the port's gemma on (2, 2) against the reference's own compiled step on
(2, 2) over 4 host placeholder devices.
"""
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.common.config import TrainConfig as RefTrainConfig
from repro.models.api import ModelAPI as RefAPI
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.params import init_params as ref_init_params
from repro.train import optimizer as ropt
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import tiny_config
from test_torch_multidevice import (B, LR, ROOT, T, TOL, _assert_tree_close,
                                    _batch, _np, _ranks, _ref_cfg, _rel,
                                    _shard)

STEPS = 3
MESHES = [(2, 2), (1, 4)]
FLOAT32_WIRE = dict(capacity_factor=4.0, dispatch_dtype="float32")
CASES = {
    # case: (arch, config overrides, moe overrides, microbatches)
    "granite": ("granite-3-2b", dict(n_kv_heads=4, head_dim=64,
                                     attn_impl="flash"), None, 2),
    "nemotron": ("nemotron-4-15b", dict(n_heads=12, n_kv_heads=3), None, 2),
    "qwen3": ("qwen3-14b", dict(n_heads=5, n_kv_heads=1), None, 1),
    "gemma": ("gemma-7b", dict(n_kv_heads=4), None, 2),
    "deepseek": ("deepseek-v2-236b", dict(fsdp=True), FLOAT32_WIRE, 1),
    "dbrx": ("dbrx-132b", dict(fsdp=True), FLOAT32_WIRE, 1),
}
PROMPT, GROW = 12, 4
# the cases also stepped once under each remat policy
POLICY_CASES = ("granite", "nemotron", "deepseek", "dbrx")


def _reference(case):
    """The reference's states, batches and results of `case`'s train
    steps, each from its own state, and its prefill and decode logits."""
    arch, over, moe, nmb = CASES[case]
    cfg = _ref_cfg(arch, over, moe)
    api = RefAPI(cfg)
    tcfg = dict(lr=LR, total_steps=10, warmup_steps=2, num_microbatches=nmb)
    step = jax.jit(ref_make_train_step(api, RefTrainConfig(**tcfg),
                                       ref_ctx(cfg)))
    rp = ref_init_params(api.param_defs(), jax.random.PRNGKey(0))
    rs = ropt.init_adam(rp)
    rng = np.random.default_rng(7)
    states, batches, results = [], [], []
    for _ in range(STEPS):
        states.append({"params": _np(rp), "m": _np(rs.m), "v": _np(rs.v),
                       "step": int(rs.step)})
        batches.append(_batch(cfg, rng))
        rp, rs, rm = step(rp, rs, batches[-1])
        results.append({"params": _np(rp), "m": _np(rs.m), "v": _np(rs.v),
                        "loss": float(rm["loss"]),
                        "grad_norm": float(rm["grad_norm"]),
                        "lr": float(rm["lr"]), "step": int(rs.step)})
    params = states[0]["params"]
    mctx = ref_ctx(cfg)
    toks = rng.integers(0, cfg.vocab, (B, PROMPT), dtype=np.int32)
    logits, cache = jax.jit(lambda p, t: api.prefill(p, {"tokens": t},
                                                     mctx))(params, toks)
    cache = jax.tree.map(lambda c: jnp.pad(
        c, [(0, 0), (0, 0), (0, GROW)] + [(0, 0)] * (c.ndim - 3)), cache)
    decode = jax.jit(lambda p, tok, pos, c: api.decode(
        p, {"token": tok, "pos": pos}, c, mctx))
    steps, want = [], []
    for i in range(2):
        tok = rng.integers(0, cfg.vocab, (B,), dtype=np.int32)
        pos = np.full((B,), PROMPT + i, np.int32)
        lg, cache = decode(params, tok, pos, cache)
        steps.append((tok, pos))
        want.append(np.asarray(lg))
    spec = {"name": arch, "over": over, "moe": moe}
    job = {"cfg": spec, "tcfg": tcfg, "seq": T, "batch": B,
           "states": states, "batches": batches,
           "policies": case in POLICY_CASES,
           "serve": {"cfg": spec, "params": params, "tokens": toks,
                     "grow": GROW, "decode": steps}}
    return job, {"train": results, "prefill": np.asarray(logits),
                 "decode": want}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's reference results, and the ranks' from one launch of
    4 gloo ranks a mesh; under "jobs", each case's job."""
    ref = {c: _reference(c) for c in CASES}
    out = {"jobs": {c: job for c, (job, _) in ref.items()}}
    for mesh in MESHES:
        jobs = [dict(job, mesh=mesh, serve=dict(job["serve"], mesh=mesh))
                for job, _ in ref.values()]
        ranks = _ranks("tp", jobs, 4, tmp_path_factory.mktemp(
            "tp_%d_%d" % mesh))
        for i, c in enumerate(CASES):
            out[(c, mesh)] = (ref[c][1], [r[i] for r in ranks])
    return out


@pytest.mark.parametrize("step", [0, STEPS - 1])
@pytest.mark.parametrize("mesh", MESHES, ids=["dp2_tp2", "tp4"])
@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(runs, case, mesh, step):
    """Loss, grad norm, lr, params, m and v after the step, on every
    rank; each rank's moment shards are its slice of the reference's."""
    want_all, ranks = runs[(case, mesh)]
    want = want_all["train"][step]
    lr = want["lr"]
    for r, got_all in enumerate(ranks):
        got = got_all["train"][step]
        assert got["step"] == want["step"]
        assert _rel(got["loss"], want["loss"]) < 1e-6, (r, got["loss"],
                                                        want["loss"])
        assert _rel(got["grad_norm"], want["grad_norm"]) < 1e-4, (
            r, got["grad_norm"], want["grad_norm"])
        assert _rel(got["lr"], want["lr"]) < 1e-6
        for key in ("params", "m", "v"):
            _assert_tree_close(got[key], want[key], 2 * lr,
                               f"{key} after step {step + 1} on rank {r}")
        shards = jax.tree.map(
            lambda full, pl: _shard(np.asarray(full), pl,
                                    got["coordinate"], mesh),
            want["m"], got["m_placements"],
            is_leaf=lambda x: isinstance(x, list))
        _assert_tree_close(got["m_local"], shards, 2 * lr,
                           f"rank {r}'s moment shards")


@pytest.mark.parametrize("mesh", MESHES, ids=["dp2_tp2", "tp4"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_logits(runs, case, mesh):
    """jit_prefill_step and two jit_decode_steps against the reference's
    one-device prefill and decode; the prefill's cache comes back placed
    by cache_pspecs: the batch over "data", kv heads over "model" where
    they divide (each rank's own heads), MLA's latent whole along it."""
    want, ranks = runs[(case, mesh)]
    arch, over, _, _ = CASES[case]
    dp, tp = mesh
    data = [("S", 1)] if dp > 1 else [("R",)]
    if case == "deepseek":
        placed = {"ckv": data + [("R",)], "krope": data + [("R",)]}
    else:
        kh = over.get("n_kv_heads", 4)
        heads = [("S", 3)] if kh % tp == 0 else [("R",)]
        placed = {"k": data + heads, "v": data + heads}
    for r, got in enumerate(ranks):
        s = got["serve"]
        assert s["cache_placements"] == placed, (r, s["cache_placements"])
        np.testing.assert_allclose(s["prefill"], want["prefill"], **TOL,
                                   err_msg=f"rank {r}")
        for i, w in enumerate(want["decode"]):
            np.testing.assert_allclose(s["decode"][i], w, **TOL,
                                       err_msg=f"rank {r} step {i}")


def _tree_equal(got, want, what: str):
    """Bit for bit, leaf by leaf."""
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want),
                    strict=True):
        assert np.asarray(g).tobytes() == np.asarray(w).tobytes(), what


@pytest.mark.parametrize("mesh", MESHES, ids=["dp2_tp2", "tp4"])
@pytest.mark.parametrize("case", POLICY_CASES)
def test_save_collectives_policy_on_the_mesh(runs, case, mesh):
    """One step from the first state under remat_policy="save_collectives"
    leaves the loss, params and moments bit for bit as "nothing" does on
    every rank, and its backward's recompute runs fewer collectives over
    "model": each layer of each microbatch skips the all-reduce after
    w_o where the q heads are over "model" (its attention's output is a
    partial sum), and a moe layer with shared experts skips the
    all-gather of its routed output. Under "nothing" the recompute of a
    layer already stops at its last kept tensor, the inputs of its last
    product (torch.utils.checkpoint's early stop), so it never ran the
    collective after w_down, nor the gather of a moe output with nothing
    after it (dbrx). The all-to-alls and the fsdp gathers, needed to
    recompute the experts' and the layer's products, stay."""
    arch, over, moe, nmb = CASES[case]
    cfg = tiny_config(arch).replace(**over)
    tp = mesh[1]
    per = cfg.n_layers * nmb if tp > 1 else 0
    skipped = {"all-reduce": per if cfg.n_heads % tp == 0 else 0,
               "all-gather": per if cfg.moe and cfg.moe.n_shared else 0}
    assert skipped["all-reduce"] > 0
    _, ranks = runs[(case, mesh)]
    for r, got in enumerate(ranks):
        base, save = (got["policies"][k] for k in ("nothing",
                                                   "save_collectives"))
        assert save["loss"] == base["loss"], r
        for key in ("params", "m", "v"):
            _tree_equal(save[key], base[key], f"{key} on rank {r}")
        kinds = set(base["collectives"]) | set(save["collectives"])
        fewer = {k: base["collectives"].get(k, 0)
                 - save["collectives"].get(k, 0) for k in kinds}
        assert fewer == {k: skipped.get(k, 0) for k in kinds}, (r, fewer)


def _group(rank: int, mesh, axis: str) -> list:
    """The ranks of `axis`'s group through `rank` on a (data, model) mesh
    numbered row-major."""
    dp, tp = mesh
    d, m = divmod(rank, tp)
    return ([d * tp + j for j in range(tp)] if axis == "model"
            else [i * tp + m for i in range(dp)])


@pytest.mark.parametrize("mesh", MESHES, ids=["dp2_tp2", "tp4"])
@pytest.mark.parametrize("case", list(CASES))
def test_no_param_is_gathered_whole(runs, case, mesh):
    """In every train step on every rank: no full_tensor() call; no
    all-gather over "model" reads a param's storage; an all-gather over
    "data" of a param's storage (an fsdp gather) makes one layer of that
    leaf, whole along "data" and this rank's shard along "model"; the
    fsdp configs make some on (2, 2)."""
    _, ranks = runs[(case, mesh)]
    fsdp = 0
    for r, got in enumerate(ranks):
        model, data = _group(r, mesh, "model"), _group(r, mesh, "data")
        for i, st in enumerate(got["steps"]):
            assert st["full_tensor_calls"] == [], (r, i)
            for ranks_of, ptr, n_in, n_out in st["gathers"]:
                leaf = st["storages"].get(ptr)
                if leaf is None:
                    continue
                path, local, whole = leaf
                assert ranks_of != model or len(model) == 1, (r, path)
                assert ranks_of == data, (r, path, ranks_of)
                layer = int(np.prod(local)) // (
                    local[0] if path.startswith("blocks/") else 1)
                assert n_out == layer * len(data), (r, path, n_out, local)
                fsdp += 1
    assert (fsdp > 0) == (CASES[case][1].get("fsdp", False)
                          and mesh[0] > 1), fsdp


REF_MESH_STEP = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, numpy as np
from repro.common.config import ShapeConfig, TrainConfig
from repro.configs import tiny_config
from repro.launch.mesh import make_host_mesh_ctx
from repro.models.api import ModelAPI
from repro.train import optimizer as ropt
from repro.train.trainer import jit_train_step
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
cfg = tiny_config(job["cfg"]["name"]).replace(**job["cfg"]["over"])
api, mctx = ModelAPI(cfg), make_host_mesh_ctx(cfg, 2, 2)
out = []
with mctx.mesh:
    step = jit_train_step(api, TrainConfig(**job["tcfg"]), mctx,
                          ShapeConfig("t", job["seq"], job["batch"], "train"),
                          donate=False)
    for state, batch in zip(job["states"], job["batches"]):
        adam = ropt.AdamState(np.int32(state["step"]), state["m"], state["v"])
        p, s, m = step(state["params"], adam, batch)
        out.append({"params": jax.tree.map(np.asarray, p),
                    "m": jax.tree.map(np.asarray, s.m),
                    "v": jax.tree.map(np.asarray, s.v),
                    "loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"])})
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def test_matches_reference_compiled_step_on_2x2(runs, tmp_path):
    """The reference's own jit_train_step on a (2, 2) mesh of 4 host
    devices, from the same states on the same batches, against the
    port's gemma steps on (2, 2), at the same tolerances."""
    with open(tmp_path / "in.pkl", "wb") as f:
        pickle.dump(runs["jobs"]["gemma"], f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", REF_MESH_STEP,
                        str(tmp_path / "in.pkl"), str(tmp_path / "out.pkl")],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp_path / "out.pkl", "rb") as f:
        sharded = pickle.load(f)
    _, ranks = runs[("gemma", (2, 2))]
    for step in (0, STEPS - 1):
        want = sharded[step]
        for rank, got_all in enumerate(ranks):
            got = got_all["train"][step]
            assert _rel(got["loss"], want["loss"]) < 1e-6, rank
            assert _rel(got["grad_norm"], want["grad_norm"]) < 1e-4, rank
            for key in ("params", "m", "v"):
                _assert_tree_close(got[key], want[key], 2 * LR,
                                   f"{key} after step {step + 1}")


FAKE_RANK = r"""
import json
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.common.config import ShapeConfig, TrainConfig
from repro_torch.configs import tiny_config
from repro_torch.models.api import ModelAPI, shardings_for
from repro_torch.models.context import MeshCtx, make_rules
from repro_torch.models.params import (_leaves, init_params, local_shape,
                                       param_shardings, sharded_zeros,
                                       tree_map, zero1_pspecs)
from repro_torch.train.optimizer import AdamState
from repro_torch.train.trainer import jit_train_step, map_tree, placed
dist.init_process_group("fake", rank=0, world_size=256, store=FakeStore())
mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))
cfg = tiny_config("gemma-7b").replace(n_heads=16, n_kv_heads=16, d_ff=256,
                                      vocab=1024)
shape = ShapeConfig("t", 32, 64, "train")
mctx = MeshCtx(device=torch.device("cpu"), mesh=mesh, rules=make_rules(cfg))
api = ModelAPI(cfg, "cpu")
defs = api.param_defs()
gen = torch.Generator().manual_seed(0)
params = init_params(defs, gen, device="cpu", mesh=mesh, rules=mctx.rules)
pls = param_shardings(defs, mesh, mctx.rules)
shards = [(list(t.to_local().shape), list(local_shape(d.shape, pl, mesh)),
           list(t.placements) == list(pl))
          for (_, t), (_, d), (_, pl) in zip(
              _leaves(params), _leaves(defs),
              _leaves(tree_map(lambda p: tuple(p), pls)))]
z = zero1_pspecs(defs, mesh, mctx.rules)
m, v = (tree_map(lambda d, s: sharded_zeros(d.shape, torch.float32, "cpu",
                                            mesh, s), defs, z)
        for _ in "mv")
specs = api.input_specs(shape)
fitted = shardings_for(mesh, specs, api.input_pspecs(mctx, shape))
batch = map_tree(lambda c, s: sharded_zeros(c.shape, c.dtype, "cpu", mesh,
                                            s), specs, fitted)
for t in batch.values():
    t.to_local().random_(0, cfg.vocab, generator=gen)
step = jit_train_step(api, TrainConfig(num_microbatches=2), mctx, shape)
out = step.step.trace(*placed(step, params,
                              AdamState(torch.zeros((), dtype=torch.int32),
                                        m, v), batch))
print(json.dumps({"shards": shards,
                  "tokens": list(batch["tokens"].to_local().shape),
                  "w_q": list(out[0]["blocks"]["attn"]["w_q"].to_local().shape),
                  "loss": float(out[2]["loss"])}))
dist.destroy_process_group()
"""


def test_rank_of_a_fake_production_mesh(tmp_path):
    """chip_smoke.py phase 12(c)'s construction on the CPU: rank 0 of a
    16 x 16 mesh over torch's fake process group, with real tensors.
    `init_params(..., mesh=)` draws only this rank's shard of each leaf at
    its param_pspecs placement, the moments and the batch are shards too,
    and the train step runs on them (its values are not the model's: the
    fake collectives move nothing)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-W", "ignore", "-c", FAKE_RANK],
                       env=env, capture_output=True, text=True, timeout=240,
                       cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for got, want, placed in out["shards"]:
        assert got == want and placed, (got, want)
    assert out["tokens"] == [4, 32]           # 64 rows over 16 data ranks
    assert out["w_q"] == [2, 64, 1, 16]       # 16 heads over 16 model ranks
    assert np.isfinite(out["loss"])
