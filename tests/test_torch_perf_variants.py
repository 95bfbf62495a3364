"""The reference's perf variants (`tests/test_perf_variants.py`) on the
port, each held against the reference on the same seeded inputs.

Params are made by the reference's `init_params` and carried across with
`params_from_numpy` (`tests/_torch_parity.py` `pair`); batches are made
from a seed with numpy. The fp8 dispatch variant has its counterpart in
`tests/test_torch_moe.py`. On a mesh, `save_collectives` is held in
`tests/test_torch_tensor_parallel.py` and `tests/test_torch_dryrun.py`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from repro.common.config import TrainConfig as RefTrainConfig
from repro.train import optimizer as ropt
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.common.config import TrainConfig
from repro_torch.launch.serve import grow_cache
from repro_torch.roofline.collectives import StepRecorder
from repro_torch.train import optimizer as opt
from repro_torch.train.trainer import make_train_step
from _torch_parity import pair, ref_grow_cache, tokens
from test_torch_train import (LR, _assert_tree_close, _rel, _state, _t)

B, S = 2, 32
GROW = 4
FP8 = "float8_e4m3fn"


def _batch(vocab, seed=1):
    toks = tokens(seed, (B, S), vocab)
    return {"tokens": toks, "labels": toks}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _steps(name, tcfg, **over):
    """The reference's (jitted) and the port's train steps of tiny `name`
    with `over`, the reference's params and the vocab."""
    (ref_api, rp, rctx), (api, _, ctx) = pair(name, "jnp", **over)
    return (jax.jit(ref_make_train_step(ref_api, RefTrainConfig(**tcfg),
                                        rctx)),
            make_train_step(api, TrainConfig(**tcfg), ctx), rp,
            api.cfg.vocab)


def test_save_collectives_policy_is_numerically_identical():
    """The reference's test on the port: remat_policy changes what the
    backward keeps, not values (1e-6, its tolerance; on one device the
    two steps run the same operations)."""
    tcfg = dict(lr=1e-3, num_microbatches=2)
    out = []
    for policy in ("nothing", "save_collectives"):
        (_, rp, _), (api, p, ctx) = pair("gemma-7b", "jnp", remat=True,
                                         remat_policy=policy)
        out.append(make_train_step(api, TrainConfig(**tcfg), ctx)(
            p, opt.init_adam(p), _torch_batch(_batch(api.cfg.vocab))))
    (p0, _, m0), (p1, _, m1) = out
    assert abs(float(m0["loss"]) - float(m1["loss"])) <= 1e-6
    for a, b in zip(jax.tree.leaves(p0), jax.tree.leaves(p1), strict=True):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_save_collectives_step_matches_reference():
    """The port's save_collectives step against the reference's (which
    keeps the outputs it names "attn_out" and "ffn_out") from the same
    state on the same batch, after 1 and 3 steps, each from the
    reference's state of the step before, at `tests/test_torch_train.py`'s
    tolerances."""
    tcfg = dict(lr=LR, total_steps=10, warmup_steps=2, num_microbatches=2)
    ref_step, step, rp, vocab = _steps("gemma-7b", tcfg, remat=True,
                                       remat_policy="save_collectives")
    rs = ropt.init_adam(rp)
    rng = np.random.default_rng(7)
    for i in range(3):
        p, s = _t(rp), _state(rs)
        toks = rng.integers(0, vocab, (4, 33), dtype=np.int32)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        rp, rs, rm = ref_step(rp, rs, batch)
        p, s, m = step(p, s, _torch_batch(batch))
        if i in (0, 2):
            assert _rel(m["loss"], rm["loss"]) < 1e-6
            assert _rel(m["grad_norm"], rm["grad_norm"]) < 1e-4
            lr = float(rm["lr"])
            for got, want, what in ((p, rp, "params"), (s.m, rs.m, "m"),
                                    (s.v, rs.v, "v")):
                _assert_tree_close(got, want, 2 * lr,
                                   f"{what} after step {i + 1}")


def test_accum_bf16_trains():
    """accum_dtype="bfloat16": the first step from the reference's state
    agrees with the reference's at `tests/test_torch_train.py`'s
    tolerances, and over three more steps on the same batch the loss
    falls in both packages (the reference's test)."""
    tcfg = dict(lr=1e-3, num_microbatches=2, accum_dtype="bfloat16")
    ref_step, step, rp, vocab = _steps("granite-3-2b", tcfg)
    batch = _batch(vocab)
    p = _t(rp)
    rp, rs, rm = ref_step(rp, ropt.init_adam(rp), batch)
    p, s, m = step(p, opt.init_adam(p), _torch_batch(batch))
    assert _rel(m["loss"], rm["loss"]) < 1e-6
    assert _rel(m["grad_norm"], rm["grad_norm"]) < 1e-4
    for got, want, what in ((p, rp, "params"), (s.m, rs.m, "m"),
                            (s.v, rs.v, "v")):
        _assert_tree_close(got, want, 2e-3, what)
    first, ref_first = float(m["loss"]), float(rm["loss"])
    assert np.isfinite(first)
    for _ in range(3):
        rp, rs, rm = ref_step(rp, rs, batch)
        p, s, m = step(p, s, _torch_batch(batch))
    assert float(m["loss"]) < first
    assert float(rm["loss"]) < ref_first


def _fp8(cache):
    """A bf16/float32 cache cast to float8_e4m3fn as torch casts it (its
    values lie far inside the format's range, where XLA's cast rounds the
    same), and the same bytes as the reference's numpy leaves."""
    port = {k: v.to(torch.float8_e4m3fn) for k, v in cache.items()}
    ref = {k: jnp.asarray(v.view(torch.uint8).numpy().view(
        ml_dtypes.float8_e4m3fn)) for k, v in port.items()}
    return port, ref


def test_kv_fp8_decode_matches_reference():
    """A decode step on a float8_e4m3fn KV cache. In both packages
    `kv_cache_dtype` sets only `cache_specs` (prefill returns its cache in
    the compute dtype), so the test casts the prefill's cache, as a server
    allocating by `cache_specs` holds it, and both packages decode from the
    same fp8 bytes: logits within the multi-device tests' 1e-4, the step's
    k and v written into the cache as fp8 alike. Against a decode on the
    prefill's own cache, the logits stay finite and their argmax mostly
    agrees (the reference's test)."""
    (ref_api, rp, rctx), (api, params, ctx) = pair(
        "qwen3-14b", "jnp", kv_cache_dtype=FP8)
    assert api.cache_specs(B, S)["k"].dtype == torch.float8_e4m3fn
    toks = tokens(2, (B, S), api.cfg.vocab)
    with torch.no_grad():
        lg, cache = api.prefill(params, {"tokens": toks}, ctx)
    rlg, _ = ref_api.prefill(rp, {"tokens": toks}, rctx)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=1e-4,
                               atol=1e-4)
    fp8, ref_fp8 = _fp8(cache)
    fam = api.cfg.family
    fp8 = grow_cache(fp8, fam, GROW)
    ref_fp8 = ref_grow_cache(ref_fp8, fam, GROW)
    as_is = grow_cache(cache, fam, GROW)
    tok = torch.argmax(lg, -1).to(torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    with torch.no_grad():
        got, fp8 = api.decode(params, {"token": tok, "pos": pos}, fp8, ctx)
        base, _ = api.decode(params, {"token": tok, "pos": pos}, as_is,
                             ctx)
    want, ref_fp8 = jax.jit(lambda p, t, q, c: ref_api.decode(
        p, {"token": t, "pos": q}, c, rctx))(rp, tok.numpy(), pos.numpy(),
                                             ref_fp8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for key in ("k", "v"):
        assert fp8[key].dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            fp8[key].view(torch.uint8).numpy(),
            np.asarray(ref_fp8[key]).view(np.uint8))
    assert torch.isfinite(got).all()
    agree = (torch.argmax(got, -1) == torch.argmax(base, -1)).float().mean()
    assert float(agree) >= 0.5, agree


def test_cache_seq_shard_noop_on_single_device():
    """cache_seq_shard=True changes nothing on one device: the prefill's
    logits and cache are bit for bit those without it, and within 1e-4 of
    the reference's prefill with it."""
    (ref_api, rp, rctx), (api, params, ctx) = pair(
        "qwen3-14b", "jnp", cache_seq_shard=True)
    _, (api0, _, _) = pair("qwen3-14b", "jnp")
    toks = tokens(3, (B, S), api.cfg.vocab)
    with torch.no_grad():
        lg, cache = api.prefill(params, {"tokens": toks}, ctx)
        lg0, cache0 = api0.prefill(params, {"tokens": toks}, ctx)
    assert torch.equal(lg, lg0)
    for key in cache0:
        assert torch.equal(cache[key], cache0[key]), key
    rlg, _ = ref_api.prefill(rp, {"tokens": toks}, rctx)
    assert np.isfinite(np.asarray(rlg)).all()
    np.testing.assert_allclose(lg.numpy(), np.asarray(rlg), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("name", ["gemma-7b", "deepseek-v2-236b"])
def test_save_collectives_keeps_each_layers_ffn_input(name):
    """What the forward keeps for the backward: under "nothing" each
    layer's input; under "save_collectives" also the input of its FFN
    (the layer's input plus the attention's output), which is what the
    reference's kept "attn_out" and "ffn_out" amount to. Counted as the
    bytes of the storages the forward makes that are alive once the loss
    is computed (`roofline.collectives.StepRecorder`): one more (B, S,
    d_model) activation a layer, in the compute dtype."""
    kept = {}
    for policy in ("nothing", "save_collectives"):
        _, (api, params, ctx) = pair(name, "jnp", remat=True,
                                     remat_policy=policy)
        for leaf in jax.tree.leaves(params):
            leaf.requires_grad_(True)
        rec = StepRecorder(params)
        with rec:
            loss = api.loss(params, _torch_batch(_batch(api.cfg.vocab)),
                            ctx)
        kept[policy] = rec.live
        del loss
    cfg = api.cfg
    act = B * S * cfg.d_model * getattr(torch, cfg.compute_dtype).itemsize
    assert kept["save_collectives"] - kept["nothing"] == cfg.n_layers * act
