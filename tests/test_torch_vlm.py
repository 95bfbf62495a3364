"""The port's VLM family (llama-3.2-vision-90b: super-blocks of self layers
and one gated cross-attention layer over projected patch embeddings)
against the reference on the CPU, in float32.

Params of the tiny config are made by the reference's `init_params` and
carried across with `params_from_numpy`. The gates start at zero, so at
init tanh(0) removes the whole cross path; every check here sets
`gate_attn` and `gate_mlp` to seeded nonzero values in both trees first.
Logits, loss, the whole prefill cache (self and cross) and three decode
steps agree within 1e-4 under attn_impl "jnp" and "flash"
(tests/test_flash_integration.py). Under "flash" the self layers' prefill
goes through the flash-attention wrapper and nothing else does.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import vlm as ref_vlm
from repro.models.params import count_params as ref_count_params
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import vlm
from repro_torch.models.params import count_params

from _torch_parity import (RefJit, assert_tree_close, normal, pair,
                           ref_grow_cache, tokens)
from repro_torch.launch.serve import grow_cache

NAME = "llama-3.2-vision-90b"
IMPLS = ["jnp", "flash"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, T = 2, 24


def open_gates(tree, seed=7):
    """Seeded gates of either sign, |g| in [0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    cross = tree["super"]["cross"]
    for key in ("gate_attn", "gate_mlp"):
        shape = cross[key].shape
        cross[key] = (rng.choice([-1.0, 1.0], shape)
                      * rng.uniform(0.5, 1.5, shape)).astype(np.float32)


def _inputs(cfg, seed):
    return {"tokens": tokens(seed, (B, T), cfg.vocab),
            "vision_embeds": normal(seed + 100, (B, cfg.vlm.n_vision_tokens,
                                                 cfg.vlm.d_vision))}


def test_param_defs_and_cache_spec_match():
    (rapi, _, _), (api, _, _) = pair(NAME, "jnp")
    defs, ref_defs = api.param_defs(), rapi.param_defs()
    assert count_params(defs) == ref_count_params(ref_defs)
    is_def = dict(is_leaf=lambda x: hasattr(x, "axes"))
    assert (jax.tree.map(lambda d: (d.shape, d.init, d.scale), defs, **is_def)
            == jax.tree.map(lambda d: (d.shape, d.init, d.scale), ref_defs,
                            **is_def))
    got, want = api.cache_specs(B, 40), rapi.cache_specs(B, 40)
    assert jax.tree.map(lambda s: (s.shape, str(s.dtype)[6:]), got,
                        is_leaf=lambda x: hasattr(x, "shape")) == \
        jax.tree.map(lambda s: (s.shape, s.dtype.name), want)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_loss_and_prefill_match(impl):
    (rapi, rparams, rctx), (api, params, ctx) = pair(NAME, impl,
                                                      tree_fn=open_gates)
    ref = RefJit(rapi, rctx)
    inp = _inputs(api.cfg, 1)
    batch = dict(inp, labels=tokens(2, (B, T), api.cfg.vocab))
    with torch.no_grad():
        logits = vlm.forward(params, torch.from_numpy(inp["tokens"]),
                             torch.from_numpy(inp["vision_embeds"]), api.cfg,
                             ctx)
        loss = api.loss(params, batch, ctx)
        last, cache = api.prefill(params, inp, ctx)
    ref_logits = jax.jit(lambda p, t, v: ref_vlm.forward(
        p, t, v, rapi.cfg, rctx))(rparams, inp["tokens"], inp["vision_embeds"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    ref_loss = ref.loss(rparams, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    ref_last, ref_cache = ref.prefill(rparams, jax.tree.map(jnp.asarray, inp))
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    assert_tree_close(cache, ref_cache, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_three_decode_steps_match(impl):
    (rapi, rparams, rctx), (api, params, ctx) = pair(NAME, impl,
                                                      tree_fn=open_gates)
    ref = RefJit(rapi, rctx)
    inp = _inputs(api.cfg, 3)
    grow = 8
    with torch.no_grad():
        _, cache = api.prefill(params, inp, ctx)
    _, ref_cache = ref.prefill(rparams, jax.tree.map(jnp.asarray, inp))
    # the self caches grow; the cross caches keep their n_vision_tokens
    cache = grow_cache(cache, "vlm", grow)
    ref_cache = ref_grow_cache(ref_cache, "vlm", grow)
    spec = api.cache_specs(B, T + grow, torch.float32)
    assert jax.tree.map(lambda s: s.shape, spec,
                        is_leaf=lambda x: hasattr(x, "shape")) == \
        jax.tree.map(lambda x: tuple(x.shape), cache)
    for i in range(3):
        tok = tokens(10 + i, (B,), api.cfg.vocab)
        pos = np.array([T + i, T + 2 * i], np.int32)     # a ragged wave
        with torch.no_grad():
            logits, cache = api.decode(params, {"token": tok, "pos": pos},
                                       cache, ctx)
        ref_logits, ref_cache = ref.decode(
            rparams, {"token": jnp.asarray(tok), "pos": jnp.asarray(pos)},
            ref_cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   **TOL)
        assert_tree_close(cache, ref_cache, **TOL)


def test_the_gates_open_the_cross_path():
    """At init (gates 0) the logits do not depend on the vision
    embeddings; with the seeded gates they do, in both packages alike."""
    inp = _inputs(pair(NAME, "jnp")[1][0].cfg, 4)
    other = dict(inp, vision_embeds=normal(5, inp["vision_embeds"].shape))
    for tree_fn, moved in ((None, False), (open_gates, True)):
        (rapi, rparams, rctx), (api, params, ctx) = pair(NAME, "jnp",
                                                          tree_fn=tree_fn)
        with torch.no_grad():
            a = api.prefill(params, inp, ctx)[0]
            b = api.prefill(params, other, ctx)[0]
        assert bool((a - b).abs().max() > 1e-3) == moved
        ref_b = RefJit(rapi, rctx).prefill(rparams,
                                           jax.tree.map(jnp.asarray, other))
        np.testing.assert_allclose(b.numpy(), np.asarray(ref_b[0]), **TOL)


def test_flash_reaches_the_kernel_in_the_self_layers_only():
    """Under "flash" the prefill calls the flash-attention wrapper once a
    self layer, with the GQA heads of the config; the cross layers and
    decode never call it."""
    _, (api, params, ctx) = pair(NAME, "flash", tree_fn=open_gates)
    cfg = api.cfg
    inp = _inputs(cfg, 6)
    calls = []
    real = flash_ops.flash_attention

    def counting(q, k, v, **kw):
        calls.append((q.shape[2], k.shape[2]))
        return real(q, k, v, **kw)

    flash_ops.flash_attention = counting
    try:
        with torch.no_grad():
            logits, cache = api.prefill(params, inp, ctx)
            n_prefill = len(calls)
            cache = grow_cache(cache, "vlm", 4)
            api.decode(params, {"token": logits.argmax(-1).int(),
                                "pos": np.full((B,), T, np.int32)}, cache,
                       ctx)
    finally:
        flash_ops.flash_attention = real
    n_self = vlm.n_super(cfg) * (cfg.vlm.cross_every - 1)
    assert (n_prefill, len(calls)) == (n_self, n_self)
    assert set(calls) == {(cfg.n_heads, cfg.n_kv_heads)}
