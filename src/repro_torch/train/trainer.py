"""The train step: microbatched gradient accumulation and the optional
int8 gradient round trip, the counterpart of `make_train_step` in
`repro/train/trainer.py`.

Gradients come from autograd over `api.loss` with the params as leaf
tensors. The reference's `jit_*` wiring (shardings, donation) waits for
the multi-device slice (ROADMAP Queue 1, "Multi-device"); on one device
the step runs eagerly and `adamw_update` updates params and moments in
place.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.models.api import ModelAPI
from repro_torch.models.context import MeshCtx
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.train.optimizer import AdamState, adamw_update


# ---------------------------------------------------------------------------
# Gradient compression

def compress_int8(tree):
    """Per-leaf symmetric int8 quantization: (q, scale). torch.round
    rounds half to even, as jnp.round does."""
    def one(x):
        xf = x.float()
        scale = torch.clamp_min(xf.abs().max(), 1e-12) / 127.0
        return (torch.clamp(torch.round(xf / scale), -127, 127)
                .to(torch.int8), scale)
    return tree_map(one, tree)


def decompress_int8(qtree):
    return tree_map(lambda q_s: q_s[0].float() * q_s[1], qtree)


# ---------------------------------------------------------------------------
# Train step

def _microbatch(batch: Dict[str, Any], nmb: int, mctx: MeshCtx):
    """(B, ...) -> (nmb, B/nmb, ...)."""
    def one(x):
        assert x.shape[0] % nmb == 0, (x.shape, nmb)
        y = x.reshape((nmb, x.shape[0] // nmb) + tuple(x.shape[1:]))
        return mctx.constraint(y)
    return {k: one(v) for k, v in batch.items()}


def value_and_grad(api: ModelAPI, params, batch, mctx: MeshCtx):
    """(loss, grads) of `api.loss` with respect to the params, which are
    leaf tensors; grads mirror params in their dtype."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    with torch.enable_grad():
        loss = api.loss(params, batch, mctx)
        flat = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(flat), params)


def make_train_step(api: ModelAPI, tcfg: TrainConfig, mctx: MeshCtx):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics)."""
    nmb = tcfg.num_microbatches

    def train_step(params, opt_state: AdamState, batch):
        if nmb > 1:
            mbs = _microbatch(batch, nmb, mctx)
            adt = getattr(torch, tcfg.accum_dtype)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=adt,
                                               device=p.device), params)
            loss_sum = None
            for i in range(nmb):
                loss, g = value_and_grad(api, params,
                                         {k: v[i] for k, v in mbs.items()},
                                         mctx)
                tree_map(lambda a, b: a.add_(b.to(adt)), grads, g)
                loss_sum = loss if loss_sum is None else loss_sum + loss
            loss = loss_sum / nmb
            tree_map(lambda g: g.div_(nmb), grads)
        else:
            loss, grads = value_and_grad(api, params, batch, mctx)

        if tcfg.grad_compression == "int8":
            # quantize-dequantize before the optimizer, as the reference
            # does; its int8 all-reduce waits for the multi-device slice
            grads = tree_map(lambda g: g.float(),
                         decompress_int8(compress_int8(grads)))

        new_params, new_opt, metrics = adamw_update(grads, opt_state, params,
                                                    tcfg)
        metrics = dict(metrics, loss=loss)
        return new_params, new_opt, metrics

    return train_step
