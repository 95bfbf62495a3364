"""Unified model API, the counterpart of `repro/models/api.py`:

    defs        = api.param_defs()
    loss        = api.loss(params, batch, mctx)
    out, cache  = api.prefill(params, inputs, mctx)
    out, cache  = api.decode(params, inputs, cache, mctx)
    api.cache_specs(batch, seq_len) -> shapes and dtypes (no allocation)

The dense (`transformer.py`), hybrid (`recurrent.py`) and ssm (`rwkv.py`)
families are ported; moe, vlm and encdec raise, naming their ROADMAP
item. Inputs may be tensors or arrays; arrays are placed on the API's
device, the CUDA card unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.context import MeshCtx


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def _m(self):
        fam = self.cfg.family
        if fam == "dense":
            from repro_torch.models import transformer as m
        elif fam == "hybrid":
            from repro_torch.models import recurrent as m
        elif fam == "ssm":
            from repro_torch.models import rwkv as m
        else:
            raise NotImplementedError(
                f"the {fam} family is not ported yet (ROADMAP Queue 1 item "
                "10, remaining families)")
        return m

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def param_defs(self):
        return self._m.param_defs(self.cfg)

    def loss(self, params, batch, mctx: MeshCtx):
        batch = {k: self._tensor(v) for k, v in batch.items()}
        return self._m.loss_fn(params, batch, self.cfg, mctx)

    def prefill(self, params, inputs: Dict[str, Any], mctx: MeshCtx):
        return self._m.prefill(params, self._tensor(inputs["tokens"]),
                               self.cfg, mctx)

    def decode(self, params, inputs: Dict[str, Any], cache, mctx: MeshCtx):
        """One decode step; the cache (or state) is updated in place and
        returned."""
        return self._m.decode_step(params, self._tensor(inputs["token"]),
                                   self._tensor(inputs["pos"]), cache,
                                   self.cfg, mctx)

    def cache_specs(self, batch: int, seq_len: int, dtype=None):
        """The dense KV cache in cfg.kv_cache_dtype, or the hybrid and ssm
        decode state (O(1) in seq_len) with its float32 and int32 leaves
        and the rest in bfloat16, unless `dtype` is given."""
        m = self._m
        if self.cfg.family == "dense":
            return m.cache_spec(self.cfg, batch, seq_len, dtype)
        return m.state_spec(self.cfg, batch,
                            torch.bfloat16 if dtype is None else dtype)
