"""AdamW + warmup-cosine schedule + global-norm clipping: the reference's
math (`repro/train/optimizer.py`), not `torch.optim`.

Params are nested dicts of tensors; the moments mirror them in float32.
`adamw_update` updates params and moments in place under
`torch.no_grad()`, the counterpart of the reference's `donate_argnums=(0,
1)`, and returns them. ZeRO-1 sharding of the moments waits for the
multi-device slice.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.models.params import tree_leaves, tree_map


class AdamState(NamedTuple):
    step: torch.Tensor      # 0-d int32
    m: Any
    v: Any


def init_adam(params) -> AdamState:
    def z(p):
        return torch.zeros_like(p, dtype=torch.float32)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamState(step=step, m=tree_map(z, params), v=tree_map(z, params))


def lr_schedule(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in float32."""
    warm = torch.clamp_max((step + 1) / max(tcfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def adamw_update(grads, state: AdamState, params, tcfg: TrainConfig):
    """Returns (params, state, metrics), params and moments updated in
    place."""
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = (torch.clamp_max(tcfg.grad_clip / torch.clamp_min(gnorm, 1e-9),
                            1.0)
            if tcfg.grad_clip > 0 else torch.ones((), device=gnorm.device))
    lr = lr_schedule(tcfg, state.step)
    b1, b2 = tcfg.b1, tcfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(g, m, v, p):
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + tcfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + tcfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)

    tree_map(upd, grads, state.m, state.v, params)
    return params, AdamState(step, state.m, state.v), {"grad_norm": gnorm,
                                                       "lr": lr}
