"""The port's train step against the reference on the CPU, in float32.

Params are made by the reference's `init_params` and carried across with
`params_from_numpy`, so both packages run the same weights; batches are
made from a seed with numpy. The reference's flash path runs its Pallas
kernels in interpret mode; the port's runs its plain versions. The tiny
dense configs keep the default `remat=True`, so the port's steps go
through activation checkpointing.

Tolerances. Loss and lr agree within 1e-6 relative and the grad norm
within 1e-4 (sums in another order). Params, m and v agree within
atol 1e-5 + rtol 1e-4 in all but 0.1% of their elements: AdamW's update
is about g / (|g| + eps), so an element whose gradient lies within float
noise of zero (or, with int8 compression, on a rounding tie) may move by
up to the step's lr in one package and less in the other; those elements
are held within 2 lr. Each step starts both packages from the
reference's state of the step before, so such differences do not compound
through the model.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.common.config import TrainConfig as RefTrainConfig
from repro.configs import tiny_config as ref_tiny_config
from repro.models.api import ModelAPI as RefAPI
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.params import init_params as ref_init_params
from repro.train import optimizer as ropt
from repro.train.trainer import compress_int8 as ref_compress_int8
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.common.config import TrainConfig
from repro_torch.configs import tiny_config
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import params_from_numpy
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import (compress_int8, decompress_int8,
                                       make_train_step, value_and_grad)

LR = 1e-2
OUTLIER_SHARE = 1e-3


def _t(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _state(ref_state: ropt.AdamState) -> opt.AdamState:
    return opt.AdamState(torch.tensor(int(ref_state.step), dtype=torch.int32),
                         _t(ref_state.m), _t(ref_state.v))


def _flat(tree) -> np.ndarray:
    leaves = jax.tree.leaves(tree)
    return np.concatenate([np.asarray(x.detach() if isinstance(
        x, torch.Tensor) else x, np.float32).ravel() for x in leaves])


def _assert_tree_close(got, want, bound: float, what: str):
    g, w = _flat(got), _flat(want)
    assert g.shape == w.shape, what
    err = np.abs(g - w)
    out = err > 1e-5 + 1e-4 * np.abs(w)
    assert out.mean() <= OUTLIER_SHARE, (what, int(out.sum()), g.size)
    assert err.max() <= bound, (what, float(err.max()))


def _rel(a, b) -> float:
    return abs(float(a) / float(b) - 1.0)


def test_adamw_update_matches_reference():
    """Three updates from the same grads, params and state: the optimizer
    math alone, elementwise, so it agrees to float rounding."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((8, 16), np.float32),
              "b": {"ln": rng.standard_normal(16).astype(np.float32)}}
    tcfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=0.5)
    rp = jax.tree.map(jnp.asarray, params)
    rs = ropt.init_adam(rp)
    p = params_from_numpy(params, device="cpu")
    s = opt.init_adam(p)
    for i in range(3):
        g = jax.tree.map(lambda x: rng.standard_normal(x.shape, np.float32)
                         * 10.0 ** (i - 1), params)
        rp, rs, rm = ropt.adamw_update(jax.tree.map(jnp.asarray, g), rs, rp,
                                       RefTrainConfig(**tcfg))
        p, s, m = opt.adamw_update(params_from_numpy(g, device="cpu"), s, p,
                                   TrainConfig(**tcfg))
        assert int(s.step) == int(rs.step) == i + 1
        assert s.step.dtype == torch.int32
        assert _rel(m["grad_norm"], rm["grad_norm"]) < 1e-6
        assert _rel(m["lr"], rm["lr"]) < 1e-6
        for got, want in ((p, rp), (s.m, rs.m), (s.v, rs.v)):
            np.testing.assert_allclose(_flat(got), _flat(want), rtol=1e-6,
                                       atol=1e-7)


def test_lr_schedule_matches_reference():
    tc = dict(lr=3e-4, warmup_steps=7, total_steps=40)
    for step in range(0, 45, 3):
        want = ropt.lr_schedule(RefTrainConfig(**tc), jnp.int32(step))
        got = opt.lr_schedule(TrainConfig(**tc),
                              torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert _rel(got, want) < 1e-6, step


def test_int8_round_trip_matches_reference():
    """Quantized values bit for bit, ties included: torch.round and
    jnp.round both round half to even."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1000).astype(np.float32)
    x[:8] = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 127.0, -127.0],
                     np.float32) / 127.0 * np.abs(x).max()
    tree = {"a": x, "b": {"c": np.zeros(5, np.float32)}}
    want = ref_compress_int8(jax.tree.map(jnp.asarray, tree))
    got = compress_int8(params_from_numpy(tree, device="cpu"))
    for (gq, gs), (wq, ws) in ((got["a"], want["a"]),
                               (got["b"]["c"], want["b"]["c"])):
        assert gq.dtype == torch.int8
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
        assert float(gs) == float(ws)
    back = decompress_int8(got)
    assert back["a"].dtype == torch.float32
    np.testing.assert_array_equal(back["b"]["c"].numpy(), np.zeros(5))


@pytest.mark.parametrize("name", ["granite-3-2b", "gemma-7b"])
def test_remat_keeps_values(name):
    """Activation checkpointing changes no loss or gradient."""
    cfg = tiny_config(name).replace(head_dim=64, attn_impl="flash")
    ctx = single_device_ctx(cfg, device="cpu")
    ref_api = RefAPI(ref_tiny_config(name).replace(head_dim=64))
    rp = ref_init_params(ref_api.param_defs(), jax.random.PRNGKey(3))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 17),
                                             dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = [value_and_grad(ModelAPI(cfg.replace(remat=r), device="cpu"),
                          _t(rp), batch, ctx) for r in (True, False)]
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(jax.tree.leaves(out[0][1]), jax.tree.leaves(out[1][1])):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


# (arch, attn_impl, microbatches, grad_compression): every option of each
# knob, on both archs
STEP_CASES = [
    ("granite-3-2b", "flash", 2, "int8"),
    ("granite-3-2b", "jnp", 1, "none"),
    ("gemma-7b", "flash", 1, "none"),
    ("gemma-7b", "jnp", 2, "int8"),
]


@pytest.mark.parametrize("name,impl,nmb,comp", STEP_CASES)
def test_train_step_matches_reference(name, impl, nmb, comp):
    """make_train_step against the reference's, after 1 and after 3 steps
    (each from the reference's state of the step before): loss, grad_norm,
    lr, params, m and v."""
    ref_cfg = ref_tiny_config(name).replace(head_dim=64, attn_impl=impl)
    cfg = tiny_config(name).replace(head_dim=64, attn_impl=impl)
    assert cfg.remat
    ref_api, api = RefAPI(ref_cfg), ModelAPI(cfg, device="cpu")
    kw = dict(lr=LR, total_steps=10, warmup_steps=2, num_microbatches=nmb,
              grad_compression=comp)
    ref_step = jax.jit(ref_make_train_step(ref_api, RefTrainConfig(**kw),
                                           ref_ctx(ref_cfg)))
    step = make_train_step(api, TrainConfig(**kw),
                           single_device_ctx(cfg, device="cpu"))
    rp = ref_init_params(ref_api.param_defs(), jax.random.PRNGKey(0))
    rs = ropt.init_adam(rp)
    rng = np.random.default_rng(7)
    for i in range(3):
        p, s = _t(rp), _state(rs)
        toks = rng.integers(0, cfg.vocab, (4, 33), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        rp, rs, rm = ref_step(rp, rs, batch)
        p, s, m = step(p, s, {k: torch.from_numpy(v)
                              for k, v in batch.items()})
        if i in (0, 2):
            assert int(s.step) == int(rs.step) == i + 1
            assert _rel(m["loss"], rm["loss"]) < 1e-6
            assert _rel(m["grad_norm"], rm["grad_norm"]) < 1e-4
            assert _rel(m["lr"], rm["lr"]) < 1e-6
            lr = float(rm["lr"])
            _assert_tree_close(p, rp, 2 * lr, f"params after step {i + 1}")
            _assert_tree_close(s.m, rs.m, 2 * lr, f"m after step {i + 1}")
            _assert_tree_close(s.v, rs.v, 2 * lr, f"v after step {i + 1}")
