"""The sharded step of the hybrid, ssm, vlm and encdec families against
the reference, on gloo CPU ranks.

Every family computes on each rank's local shards (`models/`): recurrent
channels, heads, mlp columns and vocab over "model", fsdp leaves gathered
over "data" a layer at a time. Each config below runs on a (data 2,
model 2) and a (data 1, model 4) mesh, four ranks as subprocesses of
`tests/_torch_mesh_worker.py` (case "tp", one launch of every config a
mesh, under its time limit), and is held against the reference's
one-device step from each of the reference's states in turn (three
steps, checked after the first and the third):

- recurrentgemma: 10 q heads over one kv head, as the full config has,
  which divide the model ranks at 2 (each rank projects the kv head and
  its q heads attend to it) and not at 4 (attention replicated); `d_rnn`
  96, which divides both (the RG-LRU's channels and state shard); fsdp,
  flash (the `rglru_scan` path);
- rwkv6: 4 heads, which divide both (the WKV runs on the local heads),
  flash (the `wkv6` path), no fsdp;
- vlm: fsdp, 2 kv heads, which divide at model 2 and not at 4 (every
  rank projects the kv heads and takes those its q heads use), flash, the
  cross gates seeded nonzero (at init they remove the cross path, whose
  params would take no gradient: `tests/test_torch_train_families.py`);
- whisper: 6 heads, which shard at model 2 and replicate at model 4, an
  odd vocab of 515 (embedding and logits replicated), fsdp.

Tolerances. The train step: `tests/test_torch_train.py`'s: loss and lr
within 1e-6 relative, the grad norm within 1e-4; params, m and v within
atol 1e-5 + rtol 1e-4 in all but 0.1% of their elements and within 2 lr
everywhere, each rank's moment shards its slice of the reference's
(whisper's step, at DEC_PRIME = 448 decoder tokens, too). Prefill and
two decode steps of each config on both meshes: 1e-4, the multi-device
tests' tolerance. A structure check of every train step: no
`full_tensor()`, no all-gather of a param's shard over "model", and an
all-gather of a param's shard over "data" only of one layer of it.
"""
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
from repro_torch.models.api import DEC_PRIME
from test_torch_multidevice import (B, LR, T, TOL, _assert_tree_close,
                                    _batch, _np, _ranks, _ref_cfg, _rel,
                                    _shard)
from test_torch_tensor_parallel import _group
from test_torch_train_families import open_gates

from _torch_parity import ref_grow_cache

STEPS = 3
MESHES = [(2, 2), (1, 4)]
CASES = {
    # case: (arch, config overrides, edit of the reference's params,
    #        microbatches)
    "recurrentgemma": ("recurrentgemma-2b",
                       dict(n_heads=10, fsdp=True, attn_impl="flash"),
                       None, 2),
    "rwkv6": ("rwkv6-1.6b", dict(attn_impl="flash"), None, 2),
    "vlm": ("llama-3.2-vision-90b", dict(fsdp=True, attn_impl="flash"),
            open_gates, 2),
    "whisper": ("whisper-tiny", dict(n_heads=6, n_kv_heads=6, vocab=515,
                                     fsdp=True), None, 2),
}
PROMPT, GROW = 12, 4


def _prefill_inputs(cfg, rng):
    """The prefill's inputs: PROMPT tokens (the encdec's DEC_PRIME
    decoder tokens after its frames), with the vlm's patch embeddings."""
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
                    (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab, (B, DEC_PRIME),
                                       dtype=np.int32)}
    out = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT), dtype=np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.vlm.n_vision_tokens, cfg.vlm.d_vision)).astype(np.float32)
    return out


def _reference(case):
    """The reference's states, batches and results of `case`'s train
    steps, each from its own state, and its prefill and decode logits."""
    arch, over, edit, nmb = CASES[case]
    cfg = _ref_cfg(arch, over, None)
    api = RefAPI(cfg)
    tcfg = dict(lr=LR, total_steps=10, warmup_steps=2, num_microbatches=nmb)
    step = jax.jit(ref_make_train_step(api, RefTrainConfig(**tcfg),
                                       ref_ctx(cfg)))
    rp = _np(ref_init_params(api.param_defs(), jax.random.PRNGKey(0)))
    if edit is not None:
        edit(rp)
    rp = jax.tree.map(jnp.asarray, rp)
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
    inputs = _prefill_inputs(cfg, rng)
    logits, cache = jax.jit(lambda p, i: api.prefill(p, i, mctx))(params,
                                                                   inputs)
    if cfg.family in ("vlm", "encdec"):
        cache = ref_grow_cache(cache, cfg.family, GROW)
    decode = jax.jit(lambda p, tok, pos, c: api.decode(
        p, {"token": tok, "pos": pos}, c, mctx))
    n = inputs["tokens"].shape[1]
    steps, want = [], []
    for i in range(2):
        tok = rng.integers(0, cfg.vocab, (B,), dtype=np.int32)
        pos = np.full((B,), n + i, np.int32)
        lg, cache = decode(params, tok, pos, cache)
        steps.append((tok, pos))
        want.append(np.asarray(lg))
    spec = {"name": arch, "over": over}
    seq = cfg.encdec.n_frames if cfg.family == "encdec" else T
    job = {"cfg": spec, "tcfg": tcfg, "seq": seq, "batch": B,
           "states": states, "batches": batches,
           "serve": {"cfg": spec, "params": params,
                     "tokens": inputs["tokens"],
                     "inputs": {k: v for k, v in inputs.items()
                                if k != "tokens"},
                     "seq": (cfg.encdec.n_frames if cfg.family == "encdec"
                             else PROMPT),
                     "grow": GROW, "decode": steps}}
    return job, {"train": results, "prefill": np.asarray(logits),
                 "decode": want}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case's reference results, and the ranks' from one launch of
    4 gloo ranks a mesh."""
    ref = {c: _reference(c) for c in CASES}
    out = {}
    for mesh in MESHES:
        jobs = [dict(job, mesh=mesh, serve=dict(job["serve"], mesh=mesh))
                for job, _ in ref.values()]
        ranks = _ranks("tp", jobs, 4, tmp_path_factory.mktemp(
            "tpf_%d_%d" % mesh))
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


def _placed_cache(case, mesh):
    """The placements `cache_pspecs` gives the prefill's cache leaves on
    `mesh`: the batch over "data", the recurrent channels, WKV heads and
    kv heads over "model" where they divide."""
    arch, over, _, _ = CASES[case]
    dp, tp = mesh
    R = [("R",)]

    def on(data_dim, model_dim=None):
        return ([("S", data_dim)] if dp > 1 else R) + (
            [("S", model_dim)] if model_dim is not None else R)
    if case == "recurrentgemma":            # d_rnn 96, one kv head
        return {"super": {"rec": {"h": on(2, 3), "conv": on(2, 4)},
                          "attn": {"k": on(1), "v": on(1), "kpos": on(1)}},
                "tail": {"h": on(1, 2), "conv": on(1, 3)}}
    if case == "rwkv6":                     # 4 heads
        return {"tmix": {"shift": on(1), "s": on(1, 2)},
                "cmix": {"shift": on(1)}}
    kv = over.get("n_kv_heads", 2)
    if case == "vlm":
        s = on(2, 4 if kv % tp == 0 else None)
        c = on(1, 3 if kv % tp == 0 else None)
        return {"self": {"k": s, "v": s}, "cross": {"k": c, "v": c}}
    s = on(1, 3 if kv % tp == 0 else None)
    return {"self": {"k": s, "v": s}, "cross": {"k": s, "v": s}}


@pytest.mark.parametrize("mesh", MESHES, ids=["dp2_tp2", "tp4"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_logits(runs, case, mesh):
    """jit_prefill_step and two jit_decode_steps against the reference's
    one-device prefill and decode; the prefill's cache comes back placed
    by cache_pspecs, each rank's local shards."""
    want, ranks = runs[(case, mesh)]
    placed = _placed_cache(case, mesh)
    for r, got in enumerate(ranks):
        s = got["serve"]
        assert s["cache_placements"] == placed, (r, s["cache_placements"])
        np.testing.assert_allclose(s["prefill"], want["prefill"], **TOL,
                                   err_msg=f"rank {r}")
        for i, w in enumerate(want["decode"]):
            np.testing.assert_allclose(s["decode"][i], w, **TOL,
                                       err_msg=f"rank {r} step {i}")


def _lead(path: str) -> int:
    """The stacked layer dims in front of a leaf at `path`: two in the
    hybrid's recurrent and the vlm's self super-block stacks, one in
    every other stack, none at the top level."""
    if path.startswith(("super/rec/", "super/self/")):
        return 2
    return 1 if "/" in path else 0


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
                layer = int(np.prod(local[_lead(path):]))
                assert n_out == layer * len(data), (r, path, n_out, local)
                fsdp += 1
    assert (fsdp > 0) == (CASES[case][1].get("fsdp", False)
                          and mesh[0] > 1), fsdp
