"""The port's compiled steps against the reference's (`train/trainer.py`
`jit_train_step`, `jit_prefill_step`, `jit_decode_step`, and
`ModelAPI.input_specs`), on the CPU, where a compiled step runs its body
eagerly on its static buffers.

Params are made by the reference's `init_params` and carried across with
`params_from_numpy`; inputs are made from a seed with numpy. Both
packages' steps are built on the same `ShapeConfig` and given inputs in
its `input_specs` shapes, in float32 where the tiny configs compute in
float32: jax.jit specialises on its arguments' dtypes, and the port's
buffers take the dtypes of the first call's inputs.

Tolerances. The train step: loss within 1e-6 relative, grad norm within
1e-4, params, m and v within 2 lr (`tests/test_torch_train.py`). Prefill
and decode logits and caches within 1e-4 (the model tests'). Donation is
checked by identity and by the count of leaves copied into the buffers.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common.config import SHAPES as REF_SHAPES
from repro.common.config import ShapeConfig as RefShape
from repro.common.config import TrainConfig as RefTrainConfig
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.configs import tiny_config as ref_tiny_config
from repro.models import encdec as ref_encdec
from repro.models.api import ModelAPI as RefAPI
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.params import init_params as ref_init_params
from repro.train import optimizer as ropt
from repro.train.trainer import jit_decode_step as ref_jit_decode_step
from repro.train.trainer import jit_prefill_step as ref_jit_prefill_step
from repro.train.trainer import jit_train_step as ref_jit_train_step
from repro_torch.common.config import SHAPES, ShapeConfig, TrainConfig
from repro_torch.configs import ARCHS, get_config, tiny_config
from repro_torch.launch.serve import BatchedEngine, Request, grow_cache
from repro_torch.launch.train import restore_into
from repro_torch.models import encdec
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import params_from_numpy, tree_leaves
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import (StaticStep, jit_decode_step,
                                       jit_prefill_step, jit_train_step,
                                       map_tree)

from _torch_parity import normal, pair, ref_grow_cache, tokens

LR = 1e-2
B = 2
TOL = dict(rtol=1e-4, atol=1e-4)


def _spec_tree(tree):
    """(shape, dtype name) leaves of either package's specs."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return (tuple(int(s) for s in tree.shape),
            str(tree.dtype).removeprefix("torch."))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, kind):
    assert ARCHS == REF_ARCHS
    assert [dataclasses.astuple(s) for s in SHAPES] == [
        dataclasses.astuple(s) for s in REF_SHAPES]
    shape, ref_shape = ShapeConfig(kind, 96, 3, kind), RefShape(kind, 96, 3,
                                                               kind)
    got = ModelAPI(get_config(arch), device="cpu").input_specs(shape)
    want = RefAPI(ref_get_config(arch)).input_specs(ref_shape)
    assert _spec_tree(got) == _spec_tree(want)


# -- the train step ----------------------------------------------------------
def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _rel(a, b) -> float:
    a, b = float(a), float(b)
    return abs(a - b) / max(abs(b), 1e-12)


def _assert_within(got, want, tol: float, what: str) -> None:
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        err = np.abs(g.detach().numpy() - np.asarray(w)).max()
        assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("impl,nmb,comp", [("flash", 2, "int8"),
                                           ("jnp", 1, "none")])
def test_jit_train_step_matches_reference(impl, nmb, comp):
    """Three steps of each package's jit_train_step. The reference's
    chain; the port's step takes the reference's state of the step before
    each time, as tests/test_torch_train.py does (AdamW turns float noise
    in near-zero gradients into differences of up to lr an element, which
    a chain compounds through the model). The first call's tensors become
    the step's own; later calls copy the state given into them."""
    name = "granite-3-2b"
    ref_cfg = ref_tiny_config(name).replace(head_dim=64, attn_impl=impl)
    cfg = tiny_config(name).replace(head_dim=64, attn_impl=impl)
    ref_api, api = RefAPI(ref_cfg), ModelAPI(cfg, device="cpu")
    kw = dict(lr=LR, total_steps=10, warmup_steps=2, num_microbatches=nmb,
              grad_compression=comp)
    T = 32
    ref_step = ref_jit_train_step(ref_api, RefTrainConfig(**kw),
                                  ref_ctx(ref_cfg), RefShape("t", T, 4,
                                                             "train"))
    step = jit_train_step(api, TrainConfig(**kw),
                          single_device_ctx(cfg, device="cpu"),
                          ShapeConfig("t", T, 4, "train"))
    rp = ref_init_params(ref_api.param_defs(), jax.random.PRNGKey(0))
    rs = ropt.init_adam(rp)
    rng = np.random.default_rng(7)
    first = None
    for i in range(3):
        p, s = _t(rp), opt.AdamState(
            torch.tensor(int(rs.step), dtype=torch.int32), _t(rs.m),
            _t(rs.v))
        leaves = tree_leaves(p) + tree_leaves(s.m) + tree_leaves(s.v)
        first = first or leaves + [s.step]
        toks = rng.integers(0, cfg.vocab, (4, T + 1), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        rp, rs, rm = ref_step(rp, rs, batch)
        p, s, m = step(p, s, batch)
        # the batch, and from the second call the state
        assert step.copies == 2 * (i + 1) + i * (len(leaves) + 1)
        assert int(s.step) == int(rs.step) == i + 1
        assert _rel(m["loss"], rm["loss"]) < 1e-6
        assert _rel(m["grad_norm"], rm["grad_norm"]) < 1e-4
        assert _rel(m["lr"], rm["lr"]) < 1e-6
        lr = float(rm["lr"])
        _assert_within(p, rp, 2 * lr, f"params after step {i + 1}")
        _assert_within(s.m, rs.m, 2 * lr, f"m after step {i + 1}")
        _assert_within(s.v, rs.v, 2 * lr, f"v after step {i + 1}")
        # the first call's tensors are the step's, updated in place
        assert all(a is b for a, b in zip(
            first, tree_leaves(p) + tree_leaves(s.m) + tree_leaves(s.v)
            + [s.step]))


def test_jit_train_step_chains_on_its_own_state():
    """Given its previous outputs, the donated step copies only the batch
    and takes the steps the undonated step takes."""
    step, params, state, batch, tree = _train_setup()
    plain, _, _, _, _ = _train_setup(donate=False)
    p0 = params_from_numpy(tree, device="cpu")
    s0 = opt.init_adam(p0)
    for i in range(3):
        params, state, m = step(params, state, batch)
        p0, s0, m0 = plain(p0, s0, batch)
        assert step.copies == 2 * (i + 1)
        assert float(m["loss"]) == float(m0["loss"])
        for a, b in zip(tree_leaves(params), tree_leaves(p0)):
            assert torch.equal(a, b)
    assert int(state.step) == 3


def _train_setup(donate=True):
    cfg = tiny_config("granite-3-2b")
    api = ModelAPI(cfg, device="cpu")
    ref_api = RefAPI(ref_tiny_config("granite-3-2b"))
    tree = jax.tree.map(np.asarray, ref_init_params(ref_api.param_defs(),
                                                    jax.random.PRNGKey(1)))
    step = jit_train_step(api, TrainConfig(lr=LR, total_steps=10,
                                           warmup_steps=2),
                          single_device_ctx(cfg, device="cpu"),
                          ShapeConfig("t", 16, 2, "train"), donate=donate)
    toks = tokens(3, (2, 17), cfg.vocab)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    params = params_from_numpy(tree, device="cpu")
    return step, params, opt.init_adam(params), batch, tree


def test_train_step_copies_foreign_state_and_leaves_it_untouched():
    step, params, state, batch, tree = _train_setup()
    params, state, _ = step(params, state, batch)
    n = step.copies
    foreign = params_from_numpy(tree, device="cpu")
    kept = map_tree(torch.clone, foreign)
    p2, s2, _ = step(foreign, state, batch)
    assert step.copies == n + len(tree_leaves(foreign)) + 2
    assert p2 is params
    for a, b in zip(tree_leaves(foreign), tree_leaves(kept)):
        assert torch.equal(a, b)
    # the step ran from the foreign params: one step from the initial
    # params with the state of step 1
    assert not torch.equal(p2["embed"], kept["embed"])


def test_train_step_without_donation_returns_copies():
    step, params, state, batch, _ = _train_setup(donate=False)
    kept = map_tree(torch.clone, params)
    p1, s1, _ = step(params, state, batch)
    for a, b in zip(tree_leaves(params), tree_leaves(kept)):
        assert torch.equal(a, b)
    assert int(state.step) == 0 and int(s1.step) == 1
    assert all(a is not b for a, b in zip(tree_leaves(p1),
                                          tree_leaves(step.step.buffers[
                                              "params"])))
    donated = _train_setup()[0]
    pd, _, _ = donated(map_tree(torch.clone, kept), opt.init_adam(kept),
                       batch)
    for a, b in zip(tree_leaves(p1), tree_leaves(pd)):
        assert torch.equal(a, b)


def test_resume_copies_into_the_step_state():
    step, params, state, batch, tree = _train_setup()
    params, state, _ = step(params, state, batch)
    snap = {"params": jax.tree.map(np.asarray, tree),
            "opt": ropt.AdamState(np.int32(7),
                                  jax.tree.map(np.ones_like, tree),
                                  jax.tree.map(np.zeros_like, tree))}
    leaves = tree_leaves(params) + [state.step]
    restore_into(params, state, snap)
    assert [id(x) for x in tree_leaves(params) + [state.step]] == [
        id(x) for x in leaves]
    assert int(state.step) == 7
    assert torch.equal(params["embed"],
                       torch.from_numpy(np.array(tree["embed"])))
    assert all(bool((m == 1).all()) for m in tree_leaves(state.m))


# -- prefill and decode ------------------------------------------------------
FAMILIES = {  # family -> tiny config and the configs' overrides
    "dense": ("granite-3-2b", {}),
    "moe": ("dbrx-132b", {"dispatch_dtype": "float32"}),
    "mla": ("deepseek-v2-236b", {"dispatch_dtype": "float32"}),
    "hybrid": ("recurrentgemma-2b", {}),
    "ssm": ("rwkv6-1.6b", {}),
    "vlm": ("llama-3.2-vision-90b", {}),
    "encdec": ("whisper-tiny", {}),
}
PLEN, GROW = 8, 8


def _prefill_inputs(cfg, seed):
    """Inputs as `input_specs(prefill at seq_len)` describes them."""
    if cfg.family == "encdec":
        from repro_torch.models.api import DEC_PRIME
        return {"frames": normal(seed, (B, cfg.encdec.n_frames, cfg.d_model)),
                "tokens": tokens(seed + 1, (B, DEC_PRIME), cfg.vocab)}
    out = {"tokens": tokens(seed, (B, PLEN), cfg.vocab)}
    if cfg.family == "vlm":
        out["vision_embeds"] = normal(seed + 1, (B, cfg.vlm.n_vision_tokens,
                                                 cfg.vlm.d_vision))
    return out


def _ref_table(positions, d):
    table = ref_encdec._sinusoid(jnp.asarray(positions.numpy()), d)
    return torch.from_numpy(np.array(table)).to(positions.device)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jit_prefill_and_decode_match_reference(family, monkeypatch):
    """jit_prefill_step, then four chained decode steps of jit_decode_step
    given its own cache back, against the reference's jitted steps.
    encdec's steps each start from the reference's cache (copied in): its
    prefill takes DEC_PRIME = 448 decoder tokens, and over 448 positions
    the reference's own float32 error makes the chains part by 1.6e-4 at
    the fourth step, where the reference is 1.4e-4 off a float64 run of
    the port and the port's chain 1.8e-5 (each step from the reference's
    cache: within 2.5e-5). Its logits are held; the cache entries its
    steps write part from the reference's by up to 2.7e-4 at that length
    and are not."""
    if family == "encdec":   # the reference's float32 sinusoid table
        monkeypatch.setattr(encdec, "_sinusoid", _ref_table)
    name, moe = FAMILIES[family]
    (rapi, rparams, rctx), (api, params, ctx) = pair(name, "jnp",
                                                     moe=moe or None)
    inp = _prefill_inputs(api.cfg, 5)
    plen = inp["tokens"].shape[1]
    seq = api.cfg.encdec.n_frames if family == "encdec" else plen
    pshape = ShapeConfig("p", seq, B, "prefill")
    dshape = ShapeConfig("d", plen + GROW, B, "decode")
    ref_pre = ref_jit_prefill_step(rapi, rctx, RefShape("p", seq, B,
                                                       "prefill"))
    ref_dec = ref_jit_decode_step(rapi, rctx, RefShape("d", plen + GROW, B,
                                                      "decode"))
    pre = jit_prefill_step(api, ctx, pshape)
    dec = jit_decode_step(api, ctx, dshape)

    with torch.no_grad():
        logits, cache = pre(params, inp)
    ref_logits, ref_cache = ref_pre(rparams, jax.tree.map(jnp.asarray, inp))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    fam = api.cfg.family
    cache = grow_cache(cache, fam, GROW)
    ref_cache = ref_grow_cache(ref_cache, fam, GROW) if fam in (
        "dense", "moe", "vlm", "encdec") else ref_cache
    tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    pos = np.full((B,), plen, np.int32)
    restart = family == "encdec"
    for i in range(4):
        if restart:
            cache = jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                                 ref_cache)
        with torch.no_grad():
            logits, out = dec(params, tok, pos, cache)
        ref_logits, ref_cache = ref_dec(rparams, jnp.asarray(tok),
                                        jnp.asarray(pos), ref_cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        assert all(a is b for a, b in zip(
            jax.tree.leaves(out), jax.tree.leaves(dec.buffers["cache"])))
        cache = out
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
        pos = pos + 1
    # the cache crossed once (each time when restarted); then each call
    # copied the token and position
    n_cache = len(jax.tree.leaves(cache))
    assert dec.copies == n_cache * (4 if restart else 1) + 2 * 4
    for got, want in zip(jax.tree.leaves(cache), jax.tree.leaves(ref_cache)):
        if not restart:
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(want, np.float32), **TOL)


def test_decode_copies_a_foreign_cache_and_leaves_it_untouched():
    (_, _, _), (api, params, ctx) = pair("granite-3-2b", "jnp")
    dec = jit_decode_step(api, ctx, ShapeConfig("d", 24, B, "decode"))
    with torch.no_grad():
        _, cache = api.prefill(params, {"tokens": tokens(1, (B, 16),
                                                         api.cfg.vocab)}, ctx)
    cache = grow_cache(cache, "dense", 8)
    kept = map_tree(torch.clone, cache)
    tok = torch.zeros((B,), dtype=torch.int32)
    pos = torch.full((B,), 16, dtype=torch.int32)
    with torch.no_grad():
        logits, out = dec(params, tok, pos, cache)
    assert dec.copies == 4                     # token, pos, the cache's k, v
    tok, pos = dec.buffers["token"], dec.buffers["pos"]
    for a, b in zip(tree_leaves(cache), tree_leaves(kept)):
        assert torch.equal(a, b)
    assert out["k"] is dec.buffers["cache"]["k"]
    assert torch.equal(out["k"][:, :, :16], kept["k"][:, :, :16])
    assert not torch.equal(out["k"][:, :, 16], kept["k"][:, :, 16])
    with torch.no_grad():
        dec(params, tok, pos, out)             # all the step's own: no copy
    assert dec.copies == 4
    with pytest.raises(ValueError):
        dec(params, tok, pos, grow_cache(kept, "dense", 1))
    undonated = jit_decode_step(api, ctx, ShapeConfig("d", 24, B, "decode"),
                                donate=False)
    with torch.no_grad():
        _, copy = undonated(params, tok, pos, cache)
    assert copy["k"] is not undonated.step.buffers["cache"]["k"]
    assert torch.equal(copy["k"], undonated.step.buffers["cache"]["k"])


def test_prefill_copies_other_params_into_the_captured_ones():
    (_, _, _), (api, params, ctx) = pair("granite-3-2b", "jnp")
    pre = jit_prefill_step(api, ctx, ShapeConfig("p", 16, B, "prefill"))
    inp = {"tokens": tokens(2, (B, 16), api.cfg.vocab)}
    with torch.no_grad():
        first, _ = pre(params, inp)
        other = map_tree(lambda t: t * 0.5, params)
        got, _ = pre(other, inp)
        want, _ = api.prefill(other, inp, ctx)
    assert pre.buffers["params"] is params
    assert torch.equal(params["embed"], other["embed"])
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert not torch.equal(got, first)


def test_static_step_checks_its_arguments():
    step = StaticStep(lambda x: x * 2, "cpu", {"x": torch.zeros(3)})
    with pytest.raises(TypeError):
        step()
    with pytest.raises(ValueError):
        step(torch.zeros(4))
    assert torch.equal(step(np.arange(3, dtype=np.float32)),
                       torch.tensor([0.0, 2.0, 4.0]))


@pytest.mark.parametrize("name", ["granite-3-2b", "recurrentgemma-2b",
                                  "rwkv6-1.6b"])
def test_engine_steps_equal_the_eager_engine(name):
    """The engine's compiled steps (eager bodies on static buffers on the
    CPU) and its eager steps give the same tokens over two waves, and
    the decode state is made once."""
    (_, _, _), (api, params, ctx) = pair(name, "jnp")
    outs = []
    for compiled in (("prefill", "decode"), ()):
        eng = BatchedEngine(api, params, ctx, 3, PLEN, PLEN + 8,
                            compiled=compiled)
        reqs = [Request(i, tokens(i, (PLEN,), api.cfg.vocab), 4 + i % 2)
                for i in range(5)]
        eng.run_wave(reqs[:3])
        cache = eng.cache
        eng.run_wave(reqs[3:])
        assert eng.cache is cache
        outs.append([r.out for r in reqs])
    assert outs[0] == outs[1]
    with pytest.raises(ValueError):
        BatchedEngine(api, params, ctx, 3, PLEN, PLEN + 8, compiled=("x",))
