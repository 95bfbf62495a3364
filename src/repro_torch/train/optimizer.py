"""AdamW + warmup-cosine schedule + global-norm clipping: the reference's
math (`repro/train/optimizer.py`), not `torch.optim`.

Params are nested dicts of tensors; the moments mirror them in float32.
`adamw_update` updates params and moments in place under
`torch.no_grad()`, the counterpart of the reference's `donate_argnums=(0,
1)`, and returns them.

On a mesh params, gradients and moments are DTensors: params in their
own placements, gradients and moments in the moments' (`zero1_pspecs`
shards them over the data axes too, ZeRO-1). The update runs on each
rank's local shards; a param sharded less than its moments is read at
the moments' placement (a local slice) and its new value all-gathered
back into its own (DTensor's redistribution). The global grad norm sums
every rank's shards, each element counted once over the mesh.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.common.config import TrainConfig
from repro_torch.models.params import abstract, tree_leaves, tree_map


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


def abstract_adam(params, specs=None) -> AdamState:
    """The AdamState `init_adam` would make for `params` (from
    `abstract_params`), with nothing allocated: float32 moments in the
    params' shapes, each a DTensor at its spec in `specs` where given (the
    moments' `zero1_pspecs`), else in its param's placement. The
    counterpart of the reference's `abstract_adam`."""
    def z(p, s=None):
        dev = local(p).device
        if not isinstance(p, DTensor):
            return abstract(p.shape, torch.float32, dev)
        if s is None:
            return DTensor.from_local(
                abstract(local(p).shape, torch.float32, dev), p.device_mesh,
                p.placements, run_check=False)
        return abstract(p.shape, torch.float32, dev, p.device_mesh, s)
    def moments():
        return (tree_map(z, params) if specs is None
                else tree_map(z, params, specs))
    dev = local(tree_leaves(params)[0]).device
    return AdamState(step=abstract((), torch.int32, dev), m=moments(),
                     v=moments())


def lr_schedule(tcfg: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, in float32."""
    warm = torch.clamp_max((step + 1) / max(tcfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - tcfg.warmup_steps)
                       / max(tcfg.total_steps - tcfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * prog))
    return tcfg.lr * warm * cos


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (sharing its storage); any other tensor."""
    return t.to_local() if isinstance(t, DTensor) else t


def _copies(t: torch.Tensor) -> int:
    """How many ranks hold each element of `t`: the sizes of the mesh dims
    it is replicated over (1 for a plain tensor)."""
    if not isinstance(t, DTensor):
        return 1
    n = 1
    for size, p in zip(t.device_mesh.shape, t.placements):
        n *= size if p.is_replicate() else 1
    return n


def global_norm(tree) -> torch.Tensor:
    """The l2 norm over every leaf. On a mesh each rank sums its shards,
    divided by their number of copies, and one all-reduce over the mesh
    (the default process group) adds the ranks' sums."""
    leaves = tree_leaves(tree)
    sums = [torch.sum(torch.square(local(x).float())) for x in leaves]
    if isinstance(leaves[0], DTensor):
        sums = [s / n if n > 1 else s for s, n in zip(sums, map(_copies,
                                                                leaves))]
        total = torch.sum(torch.stack(sums))
        dist.all_reduce(total)
        return torch.sqrt(total)
    return torch.sqrt(torch.sum(torch.stack(sums)))


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
        pm = p
        if isinstance(p, DTensor) and p.placements != m.placements:
            pm = p.redistribute(p.device_mesh, m.placements)
        g, m, v, new = local(g), local(m), local(v), local(pm)
        g = g.float() * clip
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * torch.square(g))
        delta = (m / bc1) / (torch.sqrt(v / bc2) + tcfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + tcfg.weight_decay * new.float()
        new = new.float() - lr * delta
        if pm is not p:   # ZeRO-1's all-gather into the param's placement
            new = DTensor.from_local(new.to(p.dtype), p.device_mesh,
                                     pm.placements).redistribute(
                p.device_mesh, p.placements).to_local()
        local(p).copy_(new)

    tree_map(upd, grads, state.m, state.v, params)
    return params, AdamState(step, state.m, state.v), {"grad_norm": gnorm,
                                                       "lr": lr}
