"""The port's encoder-decoder family (whisper-tiny: sinusoidal positions,
pre-LayerNorm, GELU MLPs, cross-attention to the encoder output) against
the reference on the CPU, in float32.

Params of the tiny config are made by the reference's `init_params` and
carried across with `params_from_numpy`. The encoder output, logits,
loss, the whole prefill cache (self and cross) and three decode steps
agree within 1e-4 under attn_impl "jnp" and "flash"
(tests/test_flash_integration.py): every attention of the family is the
plain one (the reference passes it no `impl`), so "flash" changes nothing
and reaches no kernel.

The sinusoid table is the one place where the packages differ by more
than float32 summation order: the reference's float32 exp is off by an
ulp in 4 of the tiny config's 32 frequencies, and a decode position
multiplies that, where the port rounds the float64 table once. The port's
table is held against float64 (at least as close as the reference's), and
the decode steps run on the reference's table, so that their 1e-4 sees
everything else (with the port's own float32 table, before it took the
float64 one, one cache element of 6144 was 1.03e-4 off at this seed).
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import encdec as ref_encdec
from repro.models.params import count_params as ref_count_params
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import encdec
from repro_torch.models.params import count_params

from _torch_parity import (RefJit, assert_tree_close, normal, pair,
                           ref_grow_cache, tokens)
from repro_torch.launch.serve import grow_cache

NAME = "whisper-tiny"
IMPLS = ["jnp", "flash"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, T = 2, 24


def _inputs(cfg, seed):
    return {"tokens": tokens(seed, (B, T), cfg.vocab),
            "frames": normal(seed + 100, (B, cfg.encdec.n_frames,
                                          cfg.d_model))}


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
def test_encoder_forward_loss_and_prefill_match(impl):
    (rapi, rparams, rctx), (api, params, ctx) = pair(NAME, impl)
    ref = RefJit(rapi, rctx)
    inp = _inputs(api.cfg, 1)
    batch = dict(inp, labels=tokens(2, (B, T), api.cfg.vocab))
    with torch.no_grad():
        enc = encdec.encode(params, torch.from_numpy(inp["frames"]), api.cfg,
                            ctx)
        loss = api.loss(params, batch, ctx)
        last, cache = api.prefill(params, inp, ctx)
    ref_enc = jax.jit(lambda p, f: ref_encdec.encode(p, f, rapi.cfg, rctx))(
        rparams, inp["frames"])
    np.testing.assert_allclose(enc.numpy(), np.asarray(ref_enc), **TOL)
    ref_loss = ref.loss(rparams, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    ref_last, ref_cache = ref.prefill(rparams, jax.tree.map(jnp.asarray, inp))
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **TOL)
    assert_tree_close(cache, ref_cache, **TOL)


@pytest.mark.parametrize("d", [64, 384])
def test_sinusoid_is_as_close_to_float64_as_the_reference(d):
    """Over whisper's 1,500 frames, at the tiny and the full d_model."""
    pos = np.arange(1500)
    got = encdec._sinusoid(torch.from_numpy(pos), d).double().numpy()
    ref = np.asarray(ref_encdec._sinusoid(jnp.asarray(pos), d), np.float64)
    half = d // 2
    ang = pos[:, None] * np.exp(-math.log(10000.0) * np.arange(half)
                                / max(half - 1, 1))
    exact = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    err, ref_err = np.abs(got - exact).max(), np.abs(ref - exact).max()
    assert err <= ref_err
    assert np.abs(got - ref).max() <= 2 * ref_err


def _ref_table(positions, d):
    """The reference's sinusoid table, as a tensor where the port's is."""
    table = ref_encdec._sinusoid(jnp.asarray(positions.numpy()), d)
    return torch.from_numpy(np.array(table)).to(positions.device)


@pytest.mark.parametrize("impl", IMPLS)
def test_three_decode_steps_match(impl, monkeypatch):
    monkeypatch.setattr(encdec, "_sinusoid", _ref_table)
    (rapi, rparams, rctx), (api, params, ctx) = pair(NAME, impl)
    ref = RefJit(rapi, rctx)
    inp = _inputs(api.cfg, 3)
    grow = 8
    with torch.no_grad():
        _, cache = api.prefill(params, inp, ctx)
    _, ref_cache = ref.prefill(rparams, jax.tree.map(jnp.asarray, inp))
    # the self caches grow; the cross caches keep the encoder's frames
    cache = grow_cache(cache, "encdec", grow)
    ref_cache = ref_grow_cache(ref_cache, "encdec", grow)
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


def test_flash_reaches_no_kernel():
    _, (api, params, ctx) = pair(NAME, "flash")
    inp = _inputs(api.cfg, 6)
    calls = []
    real = flash_ops.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    flash_ops.flash_attention = counting
    try:
        with torch.no_grad():
            logits, cache = api.prefill(params, inp, ctx)
            cache = grow_cache(cache, "encdec", 4)
            api.decode(params, {"token": logits.argmax(-1).int(),
                                "pos": np.full((B,), T, np.int32)}, cache,
                       ctx)
            api.loss(params, dict(inp, labels=inp["tokens"]), ctx)
    finally:
        flash_ops.flash_attention = real
    assert calls == []
