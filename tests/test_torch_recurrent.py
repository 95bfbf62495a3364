"""The port's hybrid family (RG-LRU + local MQA) against the reference on
the CPU, in float32.

Params of `tiny-recurrentgemma-2b` are made by the reference's
`init_params` and carried across with `params_from_numpy`. Logits, loss,
the prefill state (every leaf of the tree, with its dtype) and three
decode steps agree within 1e-4 (tests/test_flash_integration.py) under
attn_impl "jnp" and "flash"; loss gradients under "flash" within atol
2e-4 / rtol 2e-3 (tests/test_flash_integration.py:85-87). The window of
the tiny config is 16, so prefills at T = 32 and T = 8 take the state's
roll and pad branches. Under "flash" the recurrent blocks go through
`rglru_scan` and the local attention never reaches the flash kernel.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import tiny_config as ref_tiny_config
from repro.models import recurrent as ref_recurrent
from repro.models.api import ModelAPI as RefAPI
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.params import count_params as ref_count_params
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import tiny_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rglru_scan import ops as rglru_ops
from repro_torch.launch.serve import BatchedEngine
from repro_torch.models import recurrent
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import (count_params, params_from_numpy,
                                       params_to_numpy, tree_leaves)

NAME = "recurrentgemma-2b"
TOL = dict(atol=1e-4, rtol=1e-4)
IMPLS = ["jnp", "flash"]
B = 2


def _pair(impl, **over):
    ref_cfg = ref_tiny_config(NAME).replace(attn_impl=impl, **over)
    cfg = tiny_config(NAME).replace(attn_impl=impl, **over)
    ref_api, api = RefAPI(ref_cfg), ModelAPI(cfg, device="cpu")
    ref_params = ref_init_params(ref_api.param_defs(), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    return (ref_api, ref_params, ref_ctx(ref_cfg)), (
        api, params, single_device_ctx(cfg, device="cpu"))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def assert_tree_close(got, want, **tol):
    """Same keys, shapes and dtypes; values within tol."""
    assert (got is None) == (want is None)
    if want is None:
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            assert_tree_close(got[key], want[key], **tol)
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    np.testing.assert_allclose(got.numpy(), want, **tol)


def test_param_defs_and_state_spec_match():
    cfg = tiny_config(NAME)
    ref_cfg = ref_tiny_config(NAME)
    api = ModelAPI(cfg, device="cpu")
    defs, ref_defs = api.param_defs(), RefAPI(ref_cfg).param_defs()
    assert count_params(defs) == ref_count_params(ref_defs)
    shapes = jax.tree.map(lambda d: d.shape, ref_defs,
                          is_leaf=lambda x: hasattr(x, "axes"))
    assert jax.tree.map(lambda d: d.shape, defs,
                        is_leaf=lambda x: hasattr(x, "axes")) == shapes
    spec = api.cache_specs(3, 99)
    ref_spec = RefAPI(ref_cfg).cache_specs(3, 99)
    got = jax.tree.map(lambda s: (s.shape, str(s.dtype).removeprefix(
        "torch.")), spec, is_leaf=lambda x: hasattr(x, "dtype"))
    want = jax.tree.map(lambda s: (s.shape, s.dtype.name), ref_spec)
    assert got == want
    assert got["super"]["rec"]["h"][1] == "float32"
    assert got["super"]["attn"]["kpos"][1] == "int32"


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_params_carry_across_both_ways(name):
    """The hybrid tree (super.rec with two stacked axes, super.attn, tail)
    and the rwkv tree (blocks) cross with the dense family's converter."""
    ref_params = ref_init_params(RefAPI(ref_tiny_config(name)).param_defs(),
                                 jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, ref_params)
    params = params_from_numpy(tree, device="cpu")
    if name == NAME:
        n_super, n_tail = recurrent.pattern(tiny_config(name))
        assert params["super"]["rec"]["mix"]["w_a"].shape[:2] == (n_super, 2)
        assert params["tail"]["mix"]["lam"].shape[0] == n_tail
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_loss_match(impl):
    (rapi, rparams, rctx), (api, params, ctx) = _pair(impl)
    toks = _tokens(1, (B, 24), api.cfg.vocab)
    labels = _tokens(2, (B, 24), api.cfg.vocab)
    logits = recurrent.forward(params, torch.from_numpy(toks), api.cfg, ctx)
    ref_logits = ref_recurrent.forward(rparams, jnp.asarray(toks), rapi.cfg,
                                       rctx)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    loss = api.loss(params, {"tokens": toks, "labels": labels}, ctx)
    ref_loss = rapi.loss(rparams, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)}, rctx)
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("T", [32, 8])     # >= and < the window of 16
def test_prefill_state_and_three_decode_steps_match(impl, T):
    (rapi, rparams, rctx), (api, params, ctx) = _pair(impl)
    toks = _tokens(3 + T, (B, T), api.cfg.vocab)
    last, state = api.prefill(params, {"tokens": toks}, ctx)
    ref_last, ref_state = rapi.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                       rctx)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    assert_tree_close(state, ref_state, **TOL)
    for i in range(3):
        tok = _tokens(10 + i, (B,), api.cfg.vocab)
        # rows decode at different positions (a ragged wave)
        pos = np.array([T + i, T + 2 * i], np.int32)
        logits, state = api.decode(params, {"token": tok, "pos": pos}, state,
                                   ctx)
        ref_logits, ref_state = rapi.decode(
            rparams, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)},
            ref_state, rctx)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        assert_tree_close(state, ref_state, **TOL)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_under_flash_match(remat):
    (rapi, rparams, rctx), (api, params, ctx) = _pair("flash", remat=remat)
    toks = _tokens(4, (B, 32), api.cfg.vocab)
    batch = {"tokens": toks, "labels": toks}
    want = jax.grad(lambda p: rapi.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, rctx))(rparams)
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    api.loss(params, batch, ctx).backward()
    for got, w in zip(tree_leaves(params), jax.tree.leaves(want)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w),
                                   atol=2e-4, rtol=2e-3)


def test_flash_routes_recurrent_blocks_through_rglru_and_no_attention():
    """Under "flash" the tiny hybrid's prefill and decode call rglru_scan
    once per recurrent layer and never the flash-attention wrapper (the
    reference's local attention passes no impl); on the CPU neither
    kernel launches."""
    _, (api, params, ctx) = _pair("flash")
    n_super, n_tail = recurrent.pattern(api.cfg)
    n_rec = n_super * api.cfg.hybrid.rnn_per_attn + n_tail
    calls = {"rglru": 0, "flash": 0}
    real_scan, real_flash = rglru_ops.rglru_scan, flash_ops.flash_attention

    def scan(*a, **kw):
        calls["rglru"] += 1
        return real_scan(*a, **kw)

    def flash(*a, **kw):
        calls["flash"] += 1
        return real_flash(*a, **kw)

    rglru_before, flash_before = rglru_ops.launches(), flash_ops.launches()
    rglru_ops.rglru_scan, flash_ops.flash_attention = scan, flash
    try:
        toks = _tokens(5, (B, 32), api.cfg.vocab)
        _, state = api.prefill(params, {"tokens": toks}, ctx)
        assert calls == {"rglru": n_rec, "flash": 0}
        for i in range(2):
            api.decode(params, {"token": toks[:, i],
                                "pos": np.full((B,), 32 + i, np.int32)},
                       state, ctx)
        assert calls == {"rglru": 3 * n_rec, "flash": 0}
    finally:
        rglru_ops.rglru_scan, flash_ops.flash_attention = real_scan, real_flash
    assert rglru_ops.launches() == rglru_before
    assert flash_ops.launches() == flash_before


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_pad_cache_passes_recurrent_state_through(name):
    cfg = tiny_config(name)
    api = ModelAPI(cfg, device="cpu")
    eng = BatchedEngine(api, None, single_device_ctx(cfg, device="cpu"),
                        batch=2, prompt_len=8, max_seq=20)
    state = jax.tree.map(
        lambda s: torch.ones(s.shape, dtype=s.dtype), api.cache_specs(2, 8),
        is_leaf=lambda x: hasattr(x, "dtype"))
    assert eng._pad_cache(state) is state


def test_a_prefill_state_holds_only_its_last_positions():
    """A recurrent block's state after a T-token pass owns its rows alone
    (h its last position, conv its last w - 1): views of the scan's (B, T,
    R) output and of the padded conv input would keep them alive until
    the prefill stacks every layer's state."""
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import _layer
    cfg = tiny_config("recurrentgemma-2b")
    params = init_params(recurrent.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(2, 9, cfg.d_model)
    _, state = recurrent._block(x, _layer(params["tail"], 0), cfg, None,
                                "rec", torch.arange(9))
    r, w = cfg.hybrid.d_rnn, cfg.hybrid.conv_width
    assert state["h"].shape == (2, r)
    assert state["conv"].shape == (2, w - 1, r)
    for name, leaf in state.items():
        assert leaf.untyped_storage().nbytes() == leaf.nbytes, name
