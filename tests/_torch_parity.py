"""Helpers the port's parity tests share: one tiny config built in both
packages on the same weights, seeded inputs, and tree comparisons.

Params are made by the reference's `init_params` and carried across with
`params_from_numpy`, so both packages run the same weights.
"""
import dataclasses

import numpy as np

import jax

from repro.configs import tiny_config as ref_tiny_config
from repro.models.api import ModelAPI as RefAPI
from repro.models.context import single_device_ctx as ref_ctx
from repro.models.params import init_params as ref_init_params
from repro_torch.configs import tiny_config
from repro_torch.launch.serve import SEQ_AXIS
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import single_device_ctx
from repro_torch.models.params import params_from_numpy


def pair(name, impl, tree_fn=None, moe=None, **over):
    """((ref api, ref params, ref ctx), (api, params, ctx)) of the tiny
    config `name` with `attn_impl=impl` and `over` replaced (and the fields
    of its MoE config in `moe`), on the CPU. `tree_fn` may edit the
    reference's params (numpy) before both packages take them."""
    ref_cfg = ref_tiny_config(name).replace(attn_impl=impl, **over)
    cfg = tiny_config(name).replace(attn_impl=impl, **over)
    if moe:
        ref_cfg = ref_cfg.replace(moe=dataclasses.replace(ref_cfg.moe, **moe))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe))
    ref_api, api = RefAPI(ref_cfg), ModelAPI(cfg, device="cpu")
    tree = jax.tree.map(np.asarray, ref_init_params(ref_api.param_defs(),
                                                    jax.random.PRNGKey(0)))
    if tree_fn is not None:
        tree_fn(tree)
    params = params_from_numpy(tree, device="cpu")
    ref_params = jax.tree.map(jax.numpy.asarray, tree)
    return (ref_api, ref_params, ref_ctx(ref_cfg)), (
        api, params, single_device_ctx(cfg, device="cpu"))


def tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def assert_tree_close(got, want, **tol):
    """Same keys, shapes and dtypes; values within tol."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for key in want:
            assert_tree_close(got[key], want[key], **tol)
        return
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).removeprefix("torch.") == want.dtype.name
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)


def ref_grow_cache(cache, family, grow):
    """The reference's prefill cache grown as the port's `grow_cache` grows
    the port's: `grow` zero positions on each self-attention cache's
    sequence axis (`SEQ_AXIS`)."""
    def pad(x):
        widths = [(0, 0)] * x.ndim
        widths[SEQ_AXIS[family]] = (0, grow)
        return jax.numpy.pad(x, widths)
    if family in ("vlm", "encdec"):
        return dict(cache, self=jax.tree.map(pad, cache["self"]))
    return jax.tree.map(pad, cache)


class RefJit:
    """The reference API's loss, prefill, decode and loss gradient, each
    under jax.jit (eager shard_map, which the MoE FFN uses, is slow)."""

    def __init__(self, rapi, rctx):
        self.loss = jax.jit(lambda p, b: rapi.loss(p, b, rctx))
        self.prefill = jax.jit(lambda p, b: rapi.prefill(p, b, rctx))
        self.decode = jax.jit(lambda p, b, c: rapi.decode(p, b, c, rctx))
        self.grad = jax.jit(jax.grad(lambda p, b: rapi.loss(p, b, rctx)))
