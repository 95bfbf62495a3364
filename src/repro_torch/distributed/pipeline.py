"""GPipe pipeline parallelism over the "pod" mesh axis, the counterpart of
`repro/distributed/pipeline.py`.

Layers are split over `pod` (n_stages = its size, stage s holding layers
[s * per, (s + 1) * per)), microbatches stream through the stages, and
activations hand off to the next stage with `dist.batch_isend_irecv` over
the pod group, where the reference uses `lax.ppermute`. The schedule runs
M + S - 1 ticks; stage s is active on tick t for microbatch m = t - s.
Every tick each stage sends its output on and receives its input, zeros
on a bubble, as the reference's masked ppermute does; where the reference
computes garbage on a bubble and masks it, an inactive stage here skips
the compute. Only the last stage holds the outputs, and an all-reduce
over pod (the others add zeros) gives them to every stage, the
reference's psum.

Scope, as in the reference: forward and loss of the dense family, with
"model" = 1 (pods for pipelining, `data` for data parallelism; every
data rank runs the same pipeline on the whole batch). The hand-off is
not differentiable: the pipeline serves the forward and the loss.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.common.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF


def _stage_forward(blocks, first: int, per: int, x: torch.Tensor,
                   cfg: ModelConfig, positions) -> torch.Tensor:
    """Layers [first, first + per) on x."""
    for i in range(first, first + per):
        x, _ = TF._block(x, TF._layer(blocks, i), cfg, None, positions)
    return x


def gpipe_forward(params, tokens: torch.Tensor, cfg: ModelConfig, mesh,
                  n_micro: int) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, V), layers pipelined over "pod" of
    `mesh` (a DeviceMesh). Every rank passes the whole params and
    tokens."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_stages = sizes["pod"]
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers over {n_stages} stages")
    per = cfg.n_layers // n_stages
    B, S = tokens.shape
    if B % n_micro:
        raise ValueError(f"batch {B} in {n_micro} microbatches")
    stage = mesh.get_local_rank("pod")
    group = mesh.get_group("pod")
    last = n_stages - 1
    nxt = dist.get_global_rank(group, stage + 1) if stage < last else None
    prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None
    positions = torch.arange(S, device=tokens.device)

    x = TF._embed_in(params, tokens, cfg)
    mbs = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
    buf = torch.zeros_like(mbs[0])
    outs = torch.zeros_like(mbs)
    for t in range(n_micro + n_stages - 1):
        m = t - stage                       # microbatch index at stage
        if 0 <= m < n_micro:
            y = _stage_forward(params["blocks"], stage * per, per,
                               mbs[m] if stage == 0 else buf, cfg, positions)
            if stage == last:
                outs[m] = y
        else:
            y = torch.zeros_like(buf)
        p2p = []
        if nxt is not None:
            p2p.append(dist.P2POp(dist.isend, y.contiguous(), nxt, group))
        if prv is not None:
            buf = torch.empty_like(buf)
            p2p.append(dist.P2POp(dist.irecv, buf, prv, group))
        if p2p:
            for work in dist.batch_isend_irecv(p2p):
                work.wait()
    # only the last stage holds real outputs; the sum broadcasts them
    if stage != last:
        outs.zero_()
    dist.all_reduce(outs, group=group)
    h = outs.reshape(B, S, -1).to(x.dtype)
    h = L.rms_norm(h, params["ln_f"], cfg.rms_eps)
    return TF._unembed(params, h, cfg)


def gpipe_loss(params, batch: Dict[str, Any], cfg: ModelConfig, mesh,
               n_micro: int) -> torch.Tensor:
    logits = gpipe_forward(params, batch["tokens"], cfg, mesh, n_micro)
    return L.softmax_xent(logits, batch["labels"], batch.get("mask"))
