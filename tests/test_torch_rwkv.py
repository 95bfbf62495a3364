"""The port's ssm family (RWKV6) against the reference on the CPU, in
float32.

Params of `tiny-rwkv6-1.6b` are made by the reference's `init_params` and
carried across with `params_from_numpy`. Logits, loss, the prefill state
(every leaf, with its dtype) and three decode steps agree within 1e-4
(tests/test_flash_integration.py) under attn_impl "jnp" (the chunked
form) and "flash" (the wkv6 wrapper; on the CPU its plain version), and
the sequential form's logits too; loss gradients under "flash" within
atol 2e-4 / rtol 2e-3 (tests/test_flash_integration.py:85-87). Decode
(T = 1 with a state) takes `wkv_decode` and no kernel, as in the
reference.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import tiny_config as ref_tiny_config
from repro.models import rwkv as ref_rwkv
from repro.models.api import ModelAPI as RefAPI
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.params import count_params as ref_count_params
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import tiny_config
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops
from repro_torch.models import rwkv
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import (count_params, params_from_numpy,
                                       tree_leaves)
from test_torch_recurrent import assert_tree_close

NAME = "rwkv6-1.6b"
TOL = dict(atol=1e-4, rtol=1e-4)
IMPLS = ["jnp", "flash"]
B, T = 2, 24


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


def test_param_defs_and_state_spec_match():
    cfg, ref_cfg = tiny_config(NAME), ref_tiny_config(NAME)
    api = ModelAPI(cfg, device="cpu")
    defs, ref_defs = api.param_defs(), RefAPI(ref_cfg).param_defs()
    assert count_params(defs) == ref_count_params(ref_defs)
    shapes = jax.tree.map(lambda d: d.shape, ref_defs,
                          is_leaf=lambda x: hasattr(x, "axes"))
    assert jax.tree.map(lambda d: d.shape, defs,
                        is_leaf=lambda x: hasattr(x, "axes")) == shapes
    got = jax.tree.map(lambda s: (s.shape, str(s.dtype).removeprefix(
        "torch.")), api.cache_specs(3, 99),
        is_leaf=lambda x: hasattr(x, "dtype"))
    want = jax.tree.map(lambda s: (s.shape, s.dtype.name),
                        RefAPI(ref_cfg).cache_specs(3, 99))
    assert got == want
    assert got["tmix"]["s"][1] == "float32"


@pytest.mark.parametrize("seq_mode", ["chunked", "sequential"])
@pytest.mark.parametrize("impl", IMPLS)
def test_forward_and_loss_match(impl, seq_mode):
    (rapi, rparams, rctx), (api, params, ctx) = _pair(impl)
    toks = _tokens(1, (B, T), api.cfg.vocab)
    logits = rwkv.forward(params, torch.from_numpy(toks), api.cfg, ctx,
                          seq_mode=seq_mode)
    ref_logits = ref_rwkv.forward(rparams, jnp.asarray(toks), rapi.cfg, rctx,
                                  seq_mode=seq_mode)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    labels = _tokens(2, (B, T), api.cfg.vocab)
    loss = api.loss(params, {"tokens": toks, "labels": labels}, ctx)
    ref_loss = rapi.loss(rparams, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)}, rctx)
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_state_and_three_decode_steps_match(impl):
    (rapi, rparams, rctx), (api, params, ctx) = _pair(impl)
    toks = _tokens(3, (B, T), api.cfg.vocab)
    last, state = api.prefill(params, {"tokens": toks}, ctx)
    ref_last, ref_state = rapi.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                       rctx)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    assert_tree_close(state, ref_state, **TOL)
    before = wkv_ops.launches()
    for i in range(3):
        tok = _tokens(10 + i, (B,), api.cfg.vocab)
        pos = np.array([T + i, T + 2 * i], np.int32)
        logits, state = api.decode(params, {"token": tok, "pos": pos}, state,
                                   ctx)
        ref_logits, ref_state = rapi.decode(
            rparams, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)},
            ref_state, rctx)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        assert_tree_close(state, ref_state, **TOL)
    assert wkv_ops.launches() == before


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


def test_a_prefill_state_holds_only_its_last_position():
    """A block's state after a T-token pass owns its last position alone:
    a view of the layer's (B, T, D) input would keep that input alive
    until the prefill stacks every layer's state (at rwkv6-1.6b x
    prefill_32k, 24 x 2 inputs of 268 MB a rank)."""
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import _layer
    cfg = tiny_config("rwkv6-1.6b")
    params = init_params(rwkv.param_defs(cfg), torch.Generator().manual_seed(0),
                         device="cpu")
    x = torch.randn(2, 9, cfg.d_model)
    _, state = rwkv._block(x, _layer(params["blocks"], 0), cfg, None)
    for group in ("tmix", "cmix"):
        shift = state[group]["shift"]
        assert shift.shape == (2, cfg.d_model)
        assert shift.untyped_storage().nbytes() == shift.nbytes, group
