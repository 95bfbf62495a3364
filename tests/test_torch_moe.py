"""The port's MoE family (dbrx-132b; deepseek-v2-236b with MLA) against the
reference on the CPU, in float32.

Params of the tiny configs are made by the reference's `init_params` and
carried across with `params_from_numpy`. Logits, loss, the whole prefill
cache and three decode steps agree within 1e-4 under attn_impl "jnp" and
"flash", and loss gradients within atol 2e-4 / rtol 2e-3
(tests/test_flash_integration.py), with the dispatch payload in the
compute dtype (LOSSLESS). That is the full configs' case: they compute in
bfloat16 and dispatch in bfloat16, so their wire rounds nothing. The tiny
configs compute in float32 but keep the bfloat16 wire, which rounds every
dispatched value; a float32 ulp of difference between the two packages'
MoE inputs can then cross a bfloat16 rounding midpoint, a step of 2^-8 of
the value (1.2e-3 in a decode step's cache at this seed), so their own
wire is held at 1e-3, as the fp8 wire is. That model-level 1e-3 cannot
tell a port that skips the wire's rounding, so `moe_ffn` alone holds the
bfloat16 wire at 1e-4 on inputs that both packages compute exactly up to
each rounding, where skipping it in either direction misses even 1e-3.
`moe_ffn` alone is also held
against the reference's on seeded inputs with balanced routing, with
skewed routing that overflows `cap2` (and, at a capacity factor below 1,
`cap`), and with exact ties among the top-k candidates, where the lower
expert index must win as in `lax.top_k`. The float8_e4m3fn dispatch cast
is bit-exact with JAX's `astype`, whose NaN above 464 torch's saturating
cast lacks. MLA never reaches the flash-attention wrapper. A received
local expert id outside the rank's experts drops its row.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import tiny_config as ref_tiny_config
from repro.models import transformer as ref_transformer
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.moe import moe_ffn as ref_moe_ffn
from repro.models.params import count_params as ref_count_params
from repro_torch.configs import tiny_config
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import moe, transformer
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import count_params, tree_leaves

from _torch_parity import (RefJit, assert_tree_close, pair, ref_grow_cache,
                           tokens)
from repro_torch.launch.serve import grow_cache

NAMES = ["dbrx-132b", "deepseek-v2-236b"]
IMPLS = ["jnp", "flash"]
TOL = dict(atol=1e-4, rtol=1e-4)
GRAD_TOL = dict(atol=2e-4, rtol=2e-3)
B, T = 2, 24
FP8 = "float8_e4m3fn"
LOSSLESS = {"dispatch_dtype": "float32"}    # the tiny configs' compute dtype


def _fp8(cfg):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch_dtype=FP8))


@pytest.mark.parametrize("name", NAMES)
def test_param_defs_and_cache_spec_match(name):
    (rapi, _, _), (api, params, _) = pair(name, "jnp")
    defs, ref_defs = api.param_defs(), rapi.param_defs()
    assert count_params(defs) == ref_count_params(ref_defs)
    is_def = dict(is_leaf=lambda x: hasattr(x, "axes"))
    assert (jax.tree.map(lambda d: (d.shape, d.init, d.scale), defs, **is_def)
            == jax.tree.map(lambda d: (d.shape, d.init, d.scale), ref_defs,
                            **is_def))
    for got, want in ((api.cache_specs(B, 40), rapi.cache_specs(B, 40)),
                      (api.cache_specs(B, 40, torch.float32),
                       rapi.cache_specs(B, 40, jnp.float32))):
        assert sorted(got) == sorted(want)
        for key in want:
            assert got[key].shape == want[key].shape
            assert str(got[key].dtype).removeprefix("torch.") == \
                want[key].dtype.name


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", NAMES)
def test_forward_loss_and_prefill_match(name, impl):
    (rapi, rparams, rctx), (api, params, ctx) = pair(name, impl, moe=LOSSLESS)
    toks = tokens(1, (B, T), api.cfg.vocab)
    labels = tokens(2, (B, T), api.cfg.vocab)
    ref = RefJit(rapi, rctx)
    logits = transformer.forward(params, torch.from_numpy(toks), api.cfg, ctx)
    ref_logits = jax.jit(lambda p, t: ref_transformer.forward(
        p, t, rapi.cfg, rctx))(rparams, jnp.asarray(toks))
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(ref_logits), **TOL)
    loss = api.loss(params, {"tokens": toks, "labels": labels}, ctx)
    ref_loss = ref.loss(rparams, {"tokens": jnp.asarray(toks),
                                  "labels": jnp.asarray(labels)})
    np.testing.assert_allclose(float(loss), float(ref_loss), **TOL)
    last, cache = api.prefill(params, {"tokens": toks}, ctx)
    ref_last, ref_cache = ref.prefill(rparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(last.detach().numpy(), np.asarray(ref_last),
                               **TOL)
    assert_tree_close(cache, ref_cache, **TOL)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", NAMES)
def test_three_decode_steps_match(name, impl, moe_over=LOSSLESS, tol=TOL):
    (rapi, rparams, rctx), (api, params, ctx) = pair(name, impl,
                                                      moe=moe_over)
    ref = RefJit(rapi, rctx)
    toks = tokens(3, (B, T), api.cfg.vocab)
    grow = 8
    with torch.no_grad():
        _, cache = api.prefill(params, {"tokens": toks}, ctx)
    _, ref_cache = ref.prefill(rparams, {"tokens": jnp.asarray(toks)})
    # (L,B,S,KH,D) k and v, or MLA's (L,B,S,r) ckv and krope
    cache = grow_cache(cache, "moe", grow)
    ref_cache = ref_grow_cache(ref_cache, "moe", grow)
    spec = api.cache_specs(B, T + grow, torch.float32)
    assert {k: s.shape for k, s in spec.items()} == {
        k: tuple(x.shape) for k, x in cache.items()}
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
                                   **tol)
        assert_tree_close(cache, ref_cache, **tol)


@pytest.mark.parametrize("name", NAMES)
def test_the_configs_own_bf16_wire_matches_at_1e_3(name):
    """The tiny config as it is (float32 compute, bfloat16 wire): logits,
    loss and the prefill cache, then three decode steps, at 1e-3."""
    (rapi, rparams, rctx), (api, params, ctx) = pair(name, "flash")
    assert api.cfg.moe.dispatch_dtype == "bfloat16"
    tol = dict(atol=1e-3, rtol=1e-3)
    toks = tokens(1, (B, T), api.cfg.vocab)
    batch = {"tokens": toks, "labels": tokens(2, (B, T), api.cfg.vocab)}
    ref = RefJit(rapi, rctx)
    with torch.no_grad():
        loss = api.loss(params, batch, ctx)
        last, cache = api.prefill(params, {"tokens": toks}, ctx)
    ref_loss = ref.loss(rparams, jax.tree.map(jnp.asarray, batch))
    ref_last, ref_cache = ref.prefill(rparams, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(float(loss), float(ref_loss), **tol)
    np.testing.assert_allclose(last.numpy(), np.asarray(ref_last), **tol)
    assert_tree_close(cache, ref_cache, **tol)
    test_three_decode_steps_match(name, "flash", moe_over=None, tol=tol)


def _grads(pair_, batch):
    (rapi, rparams, rctx), (api, params, ctx) = pair_
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = api.loss(params, batch, ctx)
    grads = torch.autograd.grad(loss, leaves)
    ref_grads = RefJit(rapi, rctx).grad(
        rparams, {k: jnp.asarray(v) for k, v in batch.items()})
    return loss, grads, jax.tree.leaves(ref_grads)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", NAMES)
def test_loss_grads_match(name, impl):
    """Through the router's softmax and top-k gates, the slot scatters and
    gathers, the expert and shared MLPs and (deepseek-v2) MLA, under the
    per-layer activation checkpointing of cfg.remat."""
    pair_ = pair(name, impl, moe=LOSSLESS)
    toks = tokens(4, (B, T), pair_[1][0].cfg.vocab)
    _, grads, ref_grads = _grads(pair_, {"tokens": toks, "labels": toks})
    assert len(grads) == len(ref_grads)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


# -- moe_ffn alone, on seeded inputs -----------------------------------------
D, F = 64, 48
MOE_CASES = {
    # name: (n_experts, top_k, n_shared, capacity_factor)
    "balanced": (4, 2, 1, 1.25),
    "cap2_drops": (8, 2, 0, 1.25),
    "cap_and_cap2_drops": (8, 2, 0, 0.5),
    "exact_ties": (8, 2, 0, 1.25),
}


def _moe_case(case):
    """(ref cfg, port cfg, x (B, 2T, D), one layer's params) of a case,
    with the lossless wire."""
    E, K, n_shared, cf = MOE_CASES[case]
    mc = dict(n_experts=E, top_k=K, n_shared=n_shared, d_ff_expert=F,
              capacity_factor=cf, **LOSSLESS)
    ref_cfg = ref_tiny_config("dbrx-132b")
    ref_cfg = ref_cfg.replace(moe=dataclasses.replace(ref_cfg.moe, **mc))
    cfg = tiny_config("dbrx-132b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **mc))
    rng = np.random.default_rng(list(MOE_CASES).index(case))
    shape = (B, 2 * T, D)
    if case == "balanced":
        x = rng.standard_normal(shape)
        router = 0.02 * rng.standard_normal((D, E))
    elif case == "exact_ties":
        # integers, so the router's logits are exact in any summation
        # order: experts 0, 1 and 2 tie for the top 2 of every token
        x = rng.integers(0, 3, shape).astype(np.float64)
        router = rng.integers(-1, 2, (D, E)).astype(np.float64)
        router[:, :3] = 1.0
    else:
        # most tokens put expert 0 first
        x = 1.0 + 0.3 * rng.standard_normal(shape)
        router = 0.05 * rng.standard_normal((D, E))
        router[:, 0] += 0.5
    p = {"router": router,
         "experts": {"w_gate": rng.standard_normal((E, D, F)) / 8,
                     "w_up": rng.standard_normal((E, D, F)) / 8,
                     "w_down": rng.standard_normal((E, F, D)) / 7}}
    if n_shared:
        p["shared"] = {"w_gate": rng.standard_normal((D, F)) / 8,
                       "w_up": rng.standard_normal((D, F)) / 8,
                       "w_down": rng.standard_normal((F, D)) / 7}
    p = jax.tree.map(lambda a: a.astype(np.float32), p)
    return ref_cfg, cfg, x.astype(np.float32), p


def _loads(x, router, K, cap):
    """(assignments past `cap` in (token, k) order, the kept assignments'
    count per expert, rows with a tie at the k-th place) of the
    reference's routing, recomputed in numpy (stable descending order)."""
    logits = x.reshape(-1, x.shape[-1]).astype(np.float64) @ router
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    order = np.argsort(-probs, axis=-1, kind="stable")
    top = order[:, :K].reshape(-1)
    kept = top[:cap]
    ranked = np.take_along_axis(probs, order, -1)
    ties = int((ranked[:, K - 1] == ranked[:, K]).sum())
    loads = np.bincount(kept, minlength=router.shape[1])
    return len(top) - len(kept), loads, ties


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_matches_reference(case):
    ref_cfg, cfg, x, p = _moe_case(case)
    E, K, _, cf = MOE_CASES[case]
    n = x.shape[0] * x.shape[1]
    cap = moe._round_up(int(np.ceil(K * n * cf)), 8)
    cap2 = min(cap, moe._round_up(int(np.ceil(cap / E * 2.0)), 8))
    dropped, loads, ties = _loads(x, p["router"], K, cap)
    # each case holds what it is named for
    if case == "balanced":
        assert dropped == 0 and loads.max() <= cap2
    elif case == "cap2_drops":
        assert dropped == 0 and loads.max() > cap2
    elif case == "cap_and_cap2_drops":
        assert dropped > 0 and loads.max() > cap2
    else:
        assert ties == n and loads.max() > cap2
    got = moe.moe_ffn(torch.from_numpy(x),
                      jax.tree.map(torch.from_numpy, p), cfg,
                      single_device_ctx(cfg, device="cpu"))
    rctx = ref_ctx(ref_cfg)
    want = jax.jit(lambda x, p: ref_moe_ffn(x, p, ref_cfg, rctx))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the bfloat16 wire, on inputs that both packages compute exactly ----------
def _exact_wire_case():
    """(ref cfg, port cfg, x, params) of a moe_ffn whose values before each
    wire rounding are bit-identical in both packages, so that the
    rounding itself is what is compared: x on a grid of 2^-12 (more bits
    than bfloat16 keeps), w_in in {-1, 0, 1} / 4 (every sum exact in
    float32), the relu2 activation (one correctly rounded square) and one
    nonzero power of two a column of w_out (each output one product). The
    router, in float32 as it is, only decides the routing."""
    mc = dict(n_experts=4, top_k=2, n_shared=0, d_ff_expert=F,
              capacity_factor=1.25, dispatch_dtype="bfloat16")
    ref_cfg = ref_tiny_config("dbrx-132b")
    ref_cfg = ref_cfg.replace(act="relu2",
                              moe=dataclasses.replace(ref_cfg.moe, **mc))
    cfg = tiny_config("dbrx-132b")
    cfg = cfg.replace(act="relu2", moe=dataclasses.replace(cfg.moe, **mc))
    E = mc["n_experts"]
    rng = np.random.default_rng(11)
    x = rng.integers(-4096, 4097, (B, 2 * T, D)) * 2.0 ** -12
    w_out = np.zeros((E, F, D))
    rows = rng.integers(0, F, (E, D))
    for e in range(E):
        w_out[e, rows[e], np.arange(D)] = (rng.choice([-1, 1], D)
                                           * 2.0 ** rng.integers(-3, 1, D))
    p = {"router": 0.02 * rng.standard_normal((D, E)),
         "experts": {"w_in": rng.integers(-1, 2, (E, D, F)) * 0.25,
                     "w_out": w_out}}
    p = jax.tree.map(lambda a: a.astype(np.float32), p)
    return ref_cfg, cfg, x.astype(np.float32), p


def _wire_outputs():
    """(the port's moe_ffn, the reference's) on the exact-wire case."""
    ref_cfg, cfg, x, p = _exact_wire_case()
    got = moe.moe_ffn(torch.from_numpy(x), jax.tree.map(torch.from_numpy, p),
                      cfg, single_device_ctx(cfg, device="cpu"))
    rctx = ref_ctx(ref_cfg)
    want = jax.jit(lambda x, p: ref_moe_ffn(x, p, ref_cfg, rctx))(
        jnp.asarray(x), jax.tree.map(jnp.asarray, p))
    return got.numpy(), np.asarray(want)


def test_moe_ffn_bf16_wire_matches_at_1e_4():
    """The bfloat16 wire in both directions, at the 1e-4 of the lossless
    checks: with the values before each rounding bit-identical, no
    rounding can fall on the other side of a midpoint."""
    got, want = _wire_outputs()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("rounds", [(False, False), (True, False),
                                    (False, True)],
                         ids=["no_wire", "forward_only", "reverse_only"])
def test_moe_ffn_without_the_bf16_wire_misses_1e_3(rounds, monkeypatch):
    """A port that skipped the wire's rounding, in either direction or in
    both, is outside even 1e-3 of the reference on the exact-wire case.
    (On the tiny models' logits it is not: skipping the wire moves them
    by 0.46-0.68 of 1e-3, which is why the wire is held here.)"""
    cast, n = moe.to_dispatch, [0]

    def partial_wire(x, dtype):      # moe_ffn casts forward, then reverse
        keep = rounds[n[0] % 2]
        n[0] += 1
        return cast(x, dtype) if keep else x

    monkeypatch.setattr(moe, "to_dispatch", partial_wire)
    got, want = _wire_outputs()
    assert n[0] == 2
    err = np.abs(got - want) / (1e-3 + 1e-3 * np.abs(want))
    assert err.max() > 1.0


# -- the float8_e4m3fn dispatch -----------------------------------------------
EDGES = [448.0, -448.0, 463.99, -463.99, 464.0, -464.0, 464.01, -464.01,
         466.0, -466.0, 480.0, 1e4, np.inf, -np.inf, np.nan, -np.nan, 0.0,
         -0.0, 2.0 ** -9, -(2.0 ** -9), 2.0 ** -10, 3 * 2.0 ** -10, 1e-30,
         2.0 ** -6, 0.013671875]


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
def test_fp8_cast_is_bit_exact_with_jax(src):
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        np.array(EDGES, np.float32),
        (rng.standard_normal(1 << 16) * 300).astype(np.float32),
        (rng.standard_normal(1 << 12) * 2.0 ** -8).astype(np.float32)])
    x = torch.from_numpy(vals)
    if src == "bfloat16":
        # the same bits in both packages (torch's own float32 -> bfloat16
        # cast makes every NaN 0xffff)
        vals = vals.astype(ml_dtypes.bfloat16)
        x = torch.from_numpy(vals.view(np.int16)).view(torch.bfloat16)
    want = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn)).view(
        np.uint8)
    got = moe.to_dispatch(x, torch.float8_e4m3fn).view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)
    # torch's own cast saturates where JAX gives NaN
    plain = x.to(torch.float8_e4m3fn).view(torch.uint8).numpy()
    assert (plain != want).sum() > 0
    assert np.isnan(np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn),
                               np.float32)[8:12]).all()


def test_fp8_dispatch_logits_match_reference():
    """dbrx, the reference's fp8 dispatch config
    (tests/test_perf_variants.py), at 1e-3, not 1e-4: a float32 ulp of
    difference between the two packages' MoE inputs can move one
    dispatched value across an fp8 rounding midpoint, a step of 1/16 of
    its size."""
    (rapi, rparams, rctx), (api, params, ctx) = pair("dbrx-132b", "flash")
    rcfg, cfg = _fp8(rapi.cfg), _fp8(api.cfg)
    toks = tokens(6, (B, T), cfg.vocab)
    with torch.no_grad():
        logits = transformer.forward(params, torch.from_numpy(toks), cfg, ctx)
    ref_logits = jax.jit(lambda p, t: ref_transformer.forward(
        p, t, rcfg, rctx))(rparams, jnp.asarray(toks))
    assert np.isfinite(logits.numpy()).all()
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("name", NAMES)
def test_fp8_dispatch_loss_close_and_grads_flow(name):
    """tests/test_perf_variants.py's fp8 dispatch check, on the port: the
    loss is finite and within 10% of the bf16 dispatch's, and gradients
    flow through the fp8 cast (finite and nonzero)."""
    _, (api, params, ctx) = pair(name, "jnp")
    api8 = ModelAPI(_fp8(api.cfg), device="cpu")
    toks = tokens(7, (B, T), api.cfg.vocab)
    batch = {"tokens": toks, "labels": toks}
    with torch.no_grad():
        l0 = float(api.loss(params, batch, ctx))
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    l1 = api8.loss(params, batch, ctx)
    assert np.isfinite(l1.item())
    assert abs(l0 - l1.item()) < 0.1 * max(abs(l0), 1.0)
    grads = torch.autograd.grad(l1, leaves)
    gn = sum(float(g.abs().sum()) for g in grads)
    assert np.isfinite(gn) and gn > 0


@pytest.mark.parametrize("name", NAMES)
def test_flash_reaches_the_kernel_for_gqa_and_never_for_mla(name):
    """Under "flash", dbrx's prefill calls the flash-attention wrapper
    once a layer and its decode never; deepseek-v2's MLA never calls it
    (the reference passes MLA no `impl`, and its v head dim differs)."""
    _, (api, params, ctx) = pair(name, "flash")
    toks = tokens(8, (B, T), api.cfg.vocab)
    calls = []
    real = flash_ops.flash_attention

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    flash_ops.flash_attention = counting
    try:
        with torch.no_grad():
            logits, cache = api.prefill(params, {"tokens": toks}, ctx)
            n_prefill = len(calls)
            cache = grow_cache(cache, "moe", 4)
            api.decode(params, {"token": logits.argmax(-1).int(),
                                "pos": np.full((B,), T, np.int32)}, cache,
                       ctx)
    finally:
        flash_ops.flash_attention = real
    expect = api.cfg.n_layers if api.cfg.mla is None else 0
    assert (n_prefill, len(calls)) == (expect, expect)


UNWRITTEN_EXCHANGE = r"""
import json
import torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import tiny_config
from repro_torch.models import moe as M
from repro_torch.models import transformer
from repro_torch.models.context import MeshCtx, make_rules
from repro_torch.models.params import init_params
dist.init_process_group("fake", rank=0, world_size=4, store=FakeStore())
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
real = M._exchange


def unwritten(x, group):
    # what the receive buffer may hold when no bytes arrive in it: here
    # every id is 0x7f7f7f7f7f7f7f7f, far past the local experts
    out = real(x, group)
    out.view(torch.uint8).fill_(0x7F)
    return out


M._exchange = unwritten
out = {}
for name in ("dbrx-132b", "deepseek-v2-236b"):
    cfg = tiny_config(name)
    mctx = MeshCtx(device=torch.device("cpu"), mesh=mesh,
                   rules=make_rules(cfg))
    params = init_params(transformer.param_defs(cfg),
                         torch.Generator().manual_seed(0), device="cpu")
    p = transformer._layer(params["blocks"]["mlp"], 0)
    for leaf in (p["router"], *p["experts"].values()):
        leaf.requires_grad_(True)
    x = torch.randn(2, 8, cfg.d_model, requires_grad=True)
    y = M.moe_ffn(x, p, cfg, mctx)
    y.float().sum().backward()
    out[name] = [list(y.shape), list(x.grad.shape),
                 list(p["router"].grad.shape)]
print(json.dumps(out))
dist.destroy_process_group()
"""


def test_received_ids_outside_the_local_experts_drop_their_rows(tmp_path):
    """A receive buffer's local expert ids at or past the rank's e_per
    (what an exchange that writes nothing, as torch's fake process group's
    does, leaves in the buffer `_exchange` makes) drop their rows, as an
    id of -1 does, in the forward and the backward: the second-level
    scatter and the gather back index no row past the experts' buffer
    (on the CPU an IndexError; on the card a device-side assert, which
    ends the process). A real exchange never delivers such an id, so
    nothing else changes. On 4 fake model ranks, both tiny moe configs."""
    env = dict(os.environ, PYTHONPATH=str(
        Path(__file__).resolve().parent.parent / "src"))
    r = subprocess.run([sys.executable, "-W", "ignore", "-c",
                        UNWRITTEN_EXCHANGE], env=env, capture_output=True,
                       text=True, timeout=240, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    for name in NAMES:
        cfg = tiny_config(name)
        assert out[name] == [[2, 8, cfg.d_model], [2, 8, cfg.d_model],
                             [cfg.d_model, cfg.moe.n_experts]], name
