"""The port's multi-device layer against the reference, on gloo CPU ranks.

Each check starts its ranks as subprocesses (`tests/_torch_mesh_worker.py`,
one torch thread each) that meet through a FileStore in a temp dir, under
a time limit of their own, so a hung rank fails its check instead of
stopping the suite; the parametrised tests read the ranks' results. The
reference runs here (one device) or, where it needs a mesh of its own, in
a JAX subprocess on 4 host placeholder devices, as
`tests/test_pipeline_parallel.py` runs it.

- The train step on a (data 2, model 2) mesh, from each of the
  reference's states in turn (three steps, checked after the first and
  the third), against the reference's one-device step at
  `tests/test_torch_train.py`'s tolerances; each rank's moment shards
  equal its slice of the reference's moments. dbrx runs with capacity
  factor 4, where no assignment drops at ep = 1 or 2 (capacities depend
  on ep, so with drops the two would compute different functions), and
  with the float32 dispatch (a bf16 wire rounds float32 ulps between the
  packages across bf16 midpoints, `tests/test_torch_moe.py`).
- `moe_ffn` at ep 2, ep 4 and on (data 2, model 2) against the
  reference's at the same mesh: the bf16 and fp8 wires on inputs both
  packages compute bit-identically up to each rounding, and forced drops
  on the float32 wire, at 1e-4; every exchanged block arrives byte for
  byte as it was sent.
- GPipe on (pod 2, data 2, model 1) against the sequential forward at the
  reference's 2e-4 and 1e-4, with its sends and receives counted.
- Loss and grad norm at (data 2, model 2) for the hybrid, ssm, vlm and
  encdec families against the reference's one-device step.
- Prefill and decode steps on (data 2, model 2).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.common.config import TrainConfig as RefTrainConfig
from repro.configs import tiny_config as ref_tiny_config
from repro.models.api import ModelAPI as RefAPI
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.params import init_params as ref_init_params
from repro.train import optimizer as ropt
from repro.train.trainer import make_train_step as ref_make_train_step

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "_torch_mesh_worker.py"
RANK_TIMEOUT = 240          # s, one launch of ranks
LR = 1e-2
OUTLIER_SHARE = 1e-3
TOL = dict(atol=1e-4, rtol=1e-4)


def _ranks(case: str, jobs: list, world: int, tmp: Path) -> list:
    """The ranks' results of `case` on `jobs` (a list of per-rank lists),
    run as `world` gloo processes; fails on a hang or a rank's error."""
    tmp.mkdir(parents=True, exist_ok=True)
    src, dst = tmp / "in.pkl", tmp / "out"
    with open(src, "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), case, str(r), str(world),
         str(tmp / "store"), str(src), str(dst)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{case}: a rank hung past {RANK_TIMEOUT} s")
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"{case} rank {r}:\n{logs[r][-3000:]}"
    out = []
    for r in range(world):
        with open(f"{dst}.{r}", "rb") as f:
            out.append(pickle.load(f))
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float32).ravel()
                           for x in jax.tree.leaves(tree)])


def _assert_tree_close(got, want, bound: float, what: str):
    """tests/test_torch_train.py's check: within atol 1e-5 + rtol 1e-4 but
    for 0.1% of the elements, and every element within `bound` (2 lr)."""
    g, w = _flat(got), _flat(want)
    assert g.shape == w.shape, what
    err = np.abs(g - w)
    out = err > 1e-5 + 1e-4 * np.abs(w)
    assert out.mean() <= OUTLIER_SHARE, (what, int(out.sum()), g.size)
    assert err.max() <= bound, (what, float(err.max()))


def _rel(a, b) -> float:
    return abs(float(a) / float(b) - 1.0)


# -- the train step on (data 2, model 2) --------------------------------------
B, T = 4, 32
TRAIN = {
    # case: (arch, config overrides, moe overrides, train config)
    "granite_flash_int8": ("granite-3-2b", dict(head_dim=64,
                                                attn_impl="flash"), None,
                           dict(num_microbatches=2, grad_compression="int8")),
    "dbrx_zero1": ("dbrx-132b", {}, dict(capacity_factor=4.0,
                                         dispatch_dtype="float32"),
                   dict(num_microbatches=1)),
    "recurrentgemma": ("recurrentgemma-2b", dict(attn_impl="flash"), None,
                       dict(num_microbatches=2)),
    "rwkv6": ("rwkv6-1.6b", dict(attn_impl="flash"), None,
              dict(num_microbatches=2)),
    "vlm": ("llama-3.2-vision-90b", dict(attn_impl="flash"), None,
            dict(num_microbatches=1)),
    "whisper": ("whisper-tiny", {}, None, dict(num_microbatches=2)),
}
STEPS = {"granite_flash_int8": 3, "dbrx_zero1": 3}     # (iv): one step


def _ref_cfg(arch, over, moe):
    cfg = ref_tiny_config(arch).replace(**over)
    if moe:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    return cfg


def _batch(cfg, rng):
    if cfg.family == "encdec":
        toks = rng.integers(0, cfg.vocab, (B, 449), dtype=np.int32)
        return {"frames": rng.standard_normal(
                    (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32),
                "tokens": toks[:, :-1], "labels": toks[:, 1:]}
    toks = rng.integers(0, cfg.vocab, (B, T + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.vlm.n_vision_tokens, cfg.vlm.d_vision)).astype(np.float32)
    return out


def _train_case(case):
    """The reference's states, batches and results of `case`, stepped
    from its own state each step, and the job for the ranks."""
    arch, over, moe, tc = TRAIN[case]
    cfg = _ref_cfg(arch, over, moe)
    api = RefAPI(cfg)
    kw = dict(lr=LR, total_steps=10, warmup_steps=2, **tc)
    step = jax.jit(ref_make_train_step(api, RefTrainConfig(**kw),
                                       ref_ctx(cfg)))
    rp = ref_init_params(api.param_defs(), jax.random.PRNGKey(0))
    rs = ropt.init_adam(rp)
    rng = np.random.default_rng(7)
    states, batches, results = [], [], []
    for _ in range(STEPS.get(case, 1)):
        states.append({"params": _np(rp), "m": _np(rs.m), "v": _np(rs.v),
                       "step": int(rs.step)})
        batches.append(_batch(cfg, rng))
        rp, rs, rm = step(rp, rs, batches[-1])
        results.append({"params": _np(rp), "m": _np(rs.m), "v": _np(rs.v),
                        "loss": float(rm["loss"]),
                        "grad_norm": float(rm["grad_norm"]),
                        "lr": float(rm["lr"]), "step": int(rs.step)})
    seq = cfg.encdec.n_frames if cfg.family == "encdec" else T
    job = {"cfg": {"name": arch, "over": over, "moe": moe}, "mesh": (2, 2),
           "tcfg": kw, "seq": seq, "batch": B, "states": states,
           "batches": batches}
    return job, results


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    """Every train case: the reference's results, and the ranks' from one
    launch of 4 gloo ranks."""
    cases = {c: _train_case(c) for c in TRAIN}
    ranks = _ranks("train", [job for job, _ in cases.values()], 4,
                   tmp_path_factory.mktemp("train"))
    return {c: (cases[c][1], [r[i] for r in ranks])
            for i, c in enumerate(TRAIN)}


def _shard(full: np.ndarray, placements, coordinate, mesh_shape):
    """This rank's block of `full` under DTensor placements (even splits,
    mesh dims major to minor)."""
    idx = [slice(None)] * full.ndim
    lo = [0] * full.ndim
    size = list(full.shape)
    for p, c, n in zip(placements, coordinate, mesh_shape):
        if p[0] == "S":
            d = p[1]
            size[d] //= n
            lo[d] += c * size[d]
    for d in range(full.ndim):
        idx[d] = slice(lo[d], lo[d] + size[d])
    return full[tuple(idx)]


@pytest.mark.parametrize("case", ["granite_flash_int8", "dbrx_zero1"])
@pytest.mark.parametrize("step", [0, 2])
def test_train_step_on_a_2x2_mesh(train_runs, case, step):
    """(i): loss, grad norm, lr, params, m and v after the step, on every
    rank; each rank's moment shards are its slice of the reference's."""
    want_all, ranks = train_runs[case]
    want = want_all[step]
    lr = want["lr"]
    sharded = 0
    for r, got_all in enumerate(ranks):
        got = got_all[step]
        assert got["step"] == want["step"]
        assert _rel(got["loss"], want["loss"]) < 1e-6, (r, got["loss"])
        assert _rel(got["grad_norm"], want["grad_norm"]) < 1e-4
        assert _rel(got["lr"], want["lr"]) < 1e-6
        for key in ("params", "m", "v"):
            _assert_tree_close(got[key], want[key], 2 * lr,
                               f"{key} after step {step + 1} on rank {r}")
        shards = jax.tree.map(
            lambda full, pl: _shard(np.asarray(full), pl,
                                    got["coordinate"], (2, 2)),
            want["m"], got["m_placements"],
            is_leaf=lambda x: isinstance(x, list))
        _assert_tree_close(got["m_local"], shards, 2 * lr,
                           f"rank {r}'s moment shards")
        sharded += sum(any(p[0] == "S" for p in pl) for pl in jax.tree.leaves(
            got["m_placements"], is_leaf=lambda x: isinstance(x, list)))
    assert sharded > 0, "no moment is sharded"


def test_zero1_shards_moments_over_data(train_runs):
    """With cfg.zero1 a moment is sharded over "data" where its param is
    not: dbrx's router (replicated as a param) is split over data."""
    ranks = train_runs["dbrx_zero1"][1]
    got = ranks[0][0]
    assert got["p_placements"]["blocks"]["mlp"]["router"][0] == ("R",)
    assert got["m_placements"]["blocks"]["mlp"]["router"][0][0] == "S"


@pytest.mark.parametrize("case", ["recurrentgemma", "rwkv6", "vlm",
                                  "whisper"])
def test_loss_and_grad_norm_on_a_2x2_mesh(train_runs, case):
    """(iv): the hybrid, ssm, vlm and encdec families."""
    want_all, ranks = train_runs[case]
    want = want_all[0]
    for r, got_all in enumerate(ranks):
        got = got_all[0]
        assert _rel(got["loss"], want["loss"]) < 1e-6, (r, got["loss"])
        assert _rel(got["grad_norm"], want["grad_norm"]) < 1e-4, (
            r, got["grad_norm"], want["grad_norm"])


# -- moe_ffn at ep 2, ep 4 and (data 2, model 2) -------------------------------
MOE_MESHES = [(1, 2), (1, 4), (2, 2)]
D, F = 64, 48

REF_MOE = r"""
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import tiny_config
from repro.models.context import MeshCtx, make_mesh, make_rules
from repro.models.moe import moe_ffn
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
out = {}
for shape in job["meshes"]:
    n = shape[0] * shape[1]
    mesh = make_mesh(tuple(shape), ("data", "model"),
                     devices=jax.devices()[:n])
    for case, c in job["cases"].items():
        cfg = tiny_config(c["cfg"]["name"]).replace(**c["cfg"]["over"])
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **c["cfg"]["moe"]))
        mctx = MeshCtx(mesh=mesh, rules=make_rules(cfg))
        fn = jax.jit(lambda x, p: moe_ffn(x, p, cfg, mctx))
        out[(tuple(shape), case)] = np.asarray(fn(
            jnp.asarray(c["x"]), jax.tree.map(jnp.asarray, c["p"])))
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _exact_wire(dispatch, seed):
    """A moe_ffn whose values before each wire rounding are bit-identical
    in both packages (tests/test_torch_moe.py's exact-wire case): x on a
    2^-12 grid, w_in in {-1, 0, 1} / 4, relu2, one power of two a column
    of w_out."""
    E = 8
    rng = np.random.default_rng(seed)
    x = rng.integers(-4096, 4097, (4, 16, D)) * 2.0 ** -12
    w_out = np.zeros((E, F, D))
    rows = rng.integers(0, F, (E, D))
    for e in range(E):
        w_out[e, rows[e], np.arange(D)] = (rng.choice([-1, 1], D)
                                           * 2.0 ** rng.integers(-3, 1, D))
    p = {"router": 0.02 * rng.standard_normal((D, E)),
         "experts": {"w_in": rng.integers(-1, 2, (E, D, F)) * 0.25,
                     "w_out": w_out}}
    cfg = {"name": "dbrx-132b", "over": {"act": "relu2"},
           "moe": dict(n_experts=E, top_k=2, n_shared=0, d_ff_expert=F,
                       capacity_factor=1.25, dispatch_dtype=dispatch)}
    return {"cfg": cfg, "x": x.astype(np.float32),
            "p": jax.tree.map(lambda a: a.astype(np.float32), p)}


def _drops(seed):
    """Most tokens put expert 0 first, with a shared expert: both
    capacities drop assignments; the float32 wire."""
    E = 8
    rng = np.random.default_rng(seed)
    x = 1.0 + 0.3 * rng.standard_normal((4, 16, D))
    router = 0.05 * rng.standard_normal((D, E))
    router[:, 0] += 0.5
    p = {"router": router,
         "experts": {k: rng.standard_normal(s) / 8 for k, s in (
             ("w_gate", (E, D, F)), ("w_up", (E, D, F)),
             ("w_down", (E, F, D)))},
         "shared": {k: rng.standard_normal(s) / 8 for k, s in (
             ("w_gate", (D, F)), ("w_up", (D, F)), ("w_down", (F, D)))}}
    cfg = {"name": "dbrx-132b", "over": {},
           "moe": dict(n_experts=E, top_k=2, n_shared=1, d_ff_expert=F,
                       capacity_factor=0.5, dispatch_dtype="float32")}
    return {"cfg": cfg, "x": x.astype(np.float32),
            "p": jax.tree.map(lambda a: a.astype(np.float32), p)}


MOE_CASES = {"bf16_wire": _exact_wire("bfloat16", 11),
             "fp8_wire": _exact_wire("float8_e4m3fn", 12),
             "drops": _drops(13)}


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe")
    job = {"meshes": MOE_MESHES, "cases": MOE_CASES}
    with open(tmp / "ref_in.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REF_MOE, str(tmp / "ref_in.pkl"),
                        str(tmp / "ref_out.pkl")], env=env,
                       capture_output=True, text=True, timeout=420)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(tmp / "ref_out.pkl", "rb") as f:
        ref = pickle.load(f)
    two = _ranks("moe", [dict(job, meshes=[(1, 2)])], 2, tmp / "two")
    four = _ranks("moe", [dict(job, meshes=[(1, 4), (2, 2)])], 4,
                  tmp / "four")
    return ref, [t[0] for t in two], [f[0] for f in four]


@pytest.mark.parametrize("case", list(MOE_CASES))
@pytest.mark.parametrize("mesh", MOE_MESHES, ids=["ep2", "ep4", "dp2_ep2"])
def test_moe_ffn_matches_reference_at_the_same_mesh(moe_runs, mesh, case):
    """(ii): each rank's output block against the reference's rows of it,
    and every exchanged block received byte for byte as its peer sent it."""
    ref, two, four = moe_runs
    ranks = two if mesh == (1, 2) else four
    want = ref[(mesh, case)]
    dp, ep = mesh
    got = [r[(mesh, case)] for r in ranks]
    for r, g in enumerate(got):
        d = g["coordinate"][0]
        bl = want.shape[0] // dp
        np.testing.assert_allclose(g["y"], want[d * bl:(d + 1) * bl], **TOL,
                                   err_msg=f"rank {r}")
    # the exchanges: rank (d, m)'s block j went to (d, j), arrived as block m
    by_coord = {tuple(g["coordinate"]): g["wire"] for g in got}
    n_ex = {len(w) for w in by_coord.values()}
    assert n_ex == {3}, n_ex          # payload, expert ids, results back
    for (d, m), wire in by_coord.items():
        for i, (sent, _) in enumerate(wire):
            for j in range(ep):
                recv = by_coord[(d, j)][i][1]
                np.testing.assert_array_equal(
                    recv.reshape(ep, -1)[m], sent.reshape(ep, -1)[j])


# -- GPipe over (pod 2, data 2, model 1) -----------------------------------------
@pytest.fixture(scope="module")
def gpipe_run(tmp_path_factory):
    from repro.models import transformer as RTF
    cfg = ref_tiny_config("granite-3-2b").replace(n_layers=4, remat=False)
    api = RefAPI(cfg)
    params = ref_init_params(api.param_defs(), jax.random.PRNGKey(0))
    toks = np.asarray(jax.random.randint(jax.random.key(1), (4, 16), 0,
                                         cfg.vocab), np.int32)
    batch = {"tokens": toks, "labels": toks}
    lg = np.asarray(jax.jit(lambda p: RTF.forward(p, toks, cfg, None))(params))
    loss = float(jax.jit(lambda p: RTF.loss_fn(p, batch, cfg, None))(params))
    job = {"cfg": {"name": "granite-3-2b",
                   "over": {"n_layers": 4, "remat": False}},
           "mesh": (2, 2, 1), "params": _np(params), "tokens": toks,
           "n_micro": 2}
    ranks = _ranks("gpipe", [job], 4, tmp_path_factory.mktemp("gpipe"))
    return lg, loss, [r[0] for r in ranks]


def test_gpipe_matches_sequential(gpipe_run):
    """(iii): every rank's logits and loss against the sequential forward,
    at the reference test's tolerances."""
    lg, loss, ranks = gpipe_run
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["logits"], lg, atol=2e-4, rtol=2e-4,
                                   err_msg=f"rank {r}")
        assert abs(got["loss"] - loss) < 1e-4, (r, got["loss"], loss)


def test_gpipe_hands_off_with_send_and_recv(gpipe_run):
    """The schedule's M + S - 1 = 3 ticks: stage 0 sends on each, stage 1
    receives on each (the reference checks for its collective-permute)."""
    _, _, ranks = gpipe_run
    for got in ranks:
        stage = got["coordinate"][0]
        want = ["isend"] * 3 if stage == 0 else ["irecv"] * 3
        assert got["ops"] == want, (got["coordinate"], got["ops"])


# -- prefill and decode on (data 2, model 2) -------------------------------------
@pytest.fixture(scope="module")
def serve_runs(tmp_path_factory):
    cfg = ref_tiny_config("granite-3-2b")
    api = RefAPI(cfg)
    params = ref_init_params(api.param_defs(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab, (B, 12), dtype=np.int32)
    mctx = ref_ctx(cfg)
    logits, cache = jax.jit(lambda p, t: api.prefill(p, {"tokens": t},
                                                     mctx))(params, toks)
    grow = 4
    cache = jax.tree.map(lambda c: jnp.pad(
        c, [(0, 0), (0, 0), (0, grow), (0, 0), (0, 0)]), cache)
    decode = jax.jit(lambda p, tok, pos, c: api.decode(
        p, {"token": tok, "pos": pos}, c, mctx))
    steps, want = [], []
    for i in range(2):
        tok = rng.integers(0, cfg.vocab, (B,), dtype=np.int32)
        pos = np.full((B,), 12 + i, np.int32)
        lg, cache = decode(params, tok, pos, cache)
        steps.append((tok, pos))
        want.append(np.asarray(lg))
    job = {"cfg": {"name": "granite-3-2b"}, "mesh": (2, 2),
           "params": _np(params), "tokens": toks, "grow": grow,
           "decode": steps}
    tmp = tmp_path_factory.mktemp("serve")
    ranks = _ranks("serve", [job], 4, tmp / "serve")
    return np.asarray(logits), want, [r[0] for r in ranks]


def test_prefill_and_decode_steps_on_a_2x2_mesh(serve_runs):
    """jit_prefill_step and two jit_decode_steps, the cache placed by
    cache_pspecs (kv heads over "model", the batch over "data"), against
    the reference's one-device prefill and decode."""
    logits, want, ranks = serve_runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["prefill"], logits, **TOL)
        for i, w in enumerate(want):
            np.testing.assert_allclose(got["decode"][i], w, **TOL,
                                       err_msg=f"rank {r} step {i}")
        assert got["cache_placements"]["k"] == [("S", 1), ("S", 3)]


# -- the mesh's device: the one asked for, on a backend that serves it ---------
@pytest.fixture(params=["gloo", "cpu:gloo", None],
                ids=["gloo", "cpu_gloo", "default"])
def one_rank_group(request):
    """A one-rank process group in this process (a HashStore: no port),
    made with each way of naming its backend; destroyed after the test."""
    import torch.distributed as dist
    kw = {} if request.param is None else {"backend": request.param}
    dist.init_process_group(store=dist.HashStore(), rank=0, world_size=1,
                            **kw)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_host_mesh_takes_the_device_asked_for(one_rank_group):
    """make_host_mesh_ctx puts the mesh on the device the caller names,
    the card unless asked for the CPU, and a group without NCCL for the
    card refuses a card mesh instead of falling back to the CPU."""
    from repro_torch.configs import tiny_config
    from repro_torch.launch.mesh import make_host_mesh_ctx
    from repro_torch.models.context import make_mesh
    cfg = tiny_config("granite-3-2b")
    mctx = make_host_mesh_ctx(cfg, 1, 1, device="cpu")
    assert mctx.device.type == "cpu"
    assert mctx.device_mesh.device_type == "cpu"
    assert mctx.dp_size() == mctx.tp_size() == 1
    with pytest.raises(RuntimeError, match="CUDA device by default|nccl"):
        make_host_mesh_ctx(cfg, 1, 1)
    with pytest.raises(RuntimeError, match="nccl backend for cuda"):
        make_mesh((1, 1), ("data", "model"), "cuda")
