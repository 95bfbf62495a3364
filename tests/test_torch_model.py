"""The port's dense decoder against the reference on the CPU, in float32.

Params are made by the reference's `init_params` and carried across with
`params_from_numpy`, so both packages run the same weights. Logits, loss,
prefill caches and three decode steps must agree within 1e-4, the
tolerance of tests/test_flash_integration.py, with attn_impl "jnp" (the
plain chunked attention) and "flash" (the flash path; on the CPU its plain
version).
"""
import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import tiny_config as ref_tiny_config
from repro.models.api import ModelAPI as RefAPI
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.params import count_params as ref_count_params
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import get_config, tiny_config
from repro_torch.launch.serve import grow_cache
from repro_torch.models import transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import (count_params, init_params,
                                       params_from_numpy, params_to_numpy)

from _torch_parity import ref_grow_cache

TOL = dict(atol=1e-4, rtol=1e-4)
ARCHS = ["granite-3-2b", "gemma-7b", "qwen3-14b", "nemotron-4-15b"]
IMPLS = ["jnp", "flash"]
B, T = 2, 24


def _pair(name, impl):
    ref_cfg = ref_tiny_config(name).replace(attn_impl=impl)
    cfg = tiny_config(name).replace(attn_impl=impl)
    ref_api, api = RefAPI(ref_cfg), ModelAPI(cfg, device="cpu")
    ref_params = ref_init_params(ref_api.param_defs(), jax.random.PRNGKey(0))
    params = params_from_numpy(jax.tree.map(np.asarray, ref_params),
                               device="cpu")
    return (ref_api, ref_params, ref_ctx(ref_cfg)), (
        api, params, single_device_ctx(cfg, device="cpu"))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def test_configs_are_the_references():
    from repro.configs import get_config as ref_get_config
    for name in REF_ARCHS + ("dense-100m",):
        assert repr(get_config(name)) == repr(ref_get_config(name))
        assert repr(tiny_config(name)) == repr(ref_tiny_config(name))


@pytest.mark.parametrize("name", ARCHS)
def test_param_defs_and_count_match(name):
    cfg = tiny_config(name)
    ref_api = RefAPI(ref_tiny_config(name))
    defs = ModelAPI(cfg, device="cpu").param_defs()
    ref_defs = ref_api.param_defs()
    assert count_params(defs) == ref_count_params(ref_defs)
    shapes = jax.tree.map(lambda d: d.shape, ref_defs,
                          is_leaf=lambda x: hasattr(x, "axes"))
    assert jax.tree.map(lambda d: d.shape, defs,
                        is_leaf=lambda x: hasattr(x, "axes")) == shapes
    params = init_params(defs, torch.Generator().manual_seed(0),
                         device="cpu")
    ref_params = ref_init_params(ref_defs, jax.random.PRNGKey(0))
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(ref_params)):
        assert tuple(got.shape) == want.shape and got.dtype == torch.float32
    # same distributions: embed 0.02, ones, the reference's fan-in normal
    # (over the last-but-one dim, which for w_q is the head axis)
    assert abs(float(params["embed"].std()) - 0.02) < 2e-3
    assert torch.equal(params["ln_f"], torch.ones(cfg.d_model))
    # the MLP's output projection: w_down when gated, w_out when not
    # (nemotron-4-15b's squared-ReLU MLP)
    down = "w_down" if "w_down" in params["blocks"]["mlp"] else "w_out"
    for group, key in (("attn", "w_q"), ("attn", "w_o"), ("mlp", down)):
        got = float(params["blocks"][group][key].std())
        want = float(jnp.std(ref_params["blocks"][group][key]))
        assert abs(got / want - 1.0) < 0.1, (key, got, want)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ARCHS)
def test_forward_loss_and_prefill_match(name, impl):
    (rapi, rparams, rctx), (api, params, ctx) = _pair(name, impl)
    toks = _tokens(1, (B, T), api.cfg.vocab)
    labels = _tokens(2, (B, T), api.cfg.vocab)
    logits = transformer.forward(params, torch.from_numpy(toks), api.cfg, ctx)
    from repro.models import transformer as ref_transformer
    ref_logits = ref_transformer.forward(rparams, jnp.asarray(toks),
                                         rapi.cfg, rctx)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)

    loss = api.loss(params, {"tokens": toks, "labels": labels}, ctx)
    ref_loss = rapi.loss(rparams, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)}, rctx)
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)

    last, cache = api.prefill(params, {"tokens": toks}, ctx)
    ref_last, ref_cache = rapi.prefill(rparams, {"tokens": jnp.asarray(toks)},
                                       rctx)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == ref_cache[key].shape
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(ref_cache[key]), **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", ARCHS)
def test_three_decode_steps_match(name, impl):
    (rapi, rparams, rctx), (api, params, ctx) = _pair(name, impl)
    toks = _tokens(3, (B, T), api.cfg.vocab)
    grow = 8
    _, cache = api.prefill(params, {"tokens": toks}, ctx)
    cache = grow_cache(cache, "dense", grow)
    _, ref_cache = rapi.prefill(rparams, {"tokens": jnp.asarray(toks)}, rctx)
    ref_cache = ref_grow_cache(ref_cache, "dense", grow)
    spec = api.cache_specs(B, T + grow, torch.float32)
    assert spec["k"].shape == tuple(cache["k"].shape)
    for i in range(3):
        tok = _tokens(10 + i, (B,), api.cfg.vocab)
        # rows decode at different positions (a ragged wave)
        pos = np.array([T + i, T + 2 * i], np.int32)
        logits, cache = api.decode(params, {"token": tok, "pos": pos}, cache,
                                   ctx)
        ref_logits, ref_cache = rapi.decode(
            rparams, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)},
            ref_cache, rctx)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(cache[key].numpy(),
                                       np.asarray(ref_cache[key]), **TOL)


def test_params_round_trip_in_bfloat16():
    ref_api = RefAPI(ref_tiny_config("granite-3-2b"))
    ref_params = ref_init_params(ref_api.param_defs(), jax.random.PRNGKey(4),
                                 jnp.bfloat16)
    tree = jax.tree.map(np.asarray, ref_params)
    assert tree["embed"].dtype == ml_dtypes.bfloat16
    params = params_from_numpy(tree, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params["embed"].float().numpy(),
                                  tree["embed"].astype(np.float32))
    back = params_to_numpy(params)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.view(np.uint16),
                                      want.view(np.uint16))
    as_f32 = params_from_numpy(tree, device="cpu", dtype=torch.float32)
    assert as_f32["ln_f"].dtype == torch.float32


@pytest.mark.parametrize("name", REF_ARCHS)
def test_every_arch_builds_prefills_and_decodes(name):
    """ModelAPI(tiny_config(name), device="cpu") for each of the ten
    assigned archs: params from its defs, a prefill with the family's
    extra inputs, one decode step on the cache its prefill made, grown on
    the sequence axis as tests/test_smoke_archs.py grows it; finite logits
    of the vocabulary's width."""
    cfg = tiny_config(name)
    api = ModelAPI(cfg, device="cpu")
    ctx = single_device_ctx(cfg, device="cpu")
    params = init_params(api.param_defs(), torch.Generator().manual_seed(0),
                         device="cpu")
    inputs = {"tokens": _tokens(0, (B, T), cfg.vocab)}
    rng = np.random.default_rng(0)
    if cfg.family == "vlm":
        inputs["vision_embeds"] = rng.standard_normal(
            (B, cfg.vlm.n_vision_tokens, cfg.vlm.d_vision), np.float32)
    if cfg.family == "encdec":
        inputs["frames"] = rng.standard_normal(
            (B, cfg.encdec.n_frames, cfg.d_model), np.float32)
    with torch.no_grad():
        logits, cache = api.prefill(params, inputs, ctx)
        assert tuple(logits.shape) == (B, cfg.vocab)
        cache = grow_cache(cache, cfg.family, 4)
        logits, _ = api.decode(params, {"token": logits.argmax(-1).int(),
                                        "pos": np.full((B,), T, np.int32)},
                               cache, ctx)
    assert tuple(logits.shape) == (B, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


def test_model_api_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = tiny_config("granite-3-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelAPI(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        single_device_ctx(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(ModelAPI(cfg, device="cpu").param_defs(),
                    torch.Generator())
