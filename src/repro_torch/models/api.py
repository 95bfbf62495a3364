"""Unified model API, the counterpart of `repro/models/api.py`:

    defs        = api.param_defs()
    loss        = api.loss(params, batch, mctx)
    out, cache  = api.prefill(params, inputs, mctx)
    out, cache  = api.decode(params, inputs, cache, mctx)
    api.cache_specs(batch, seq_len) -> shapes and dtypes (no allocation)
    api.input_specs(shape)          -> the step's inputs, likewise

Every family of the reference is ported: dense and moe (`transformer.py`,
with `moe.py`), hybrid (`recurrent.py`), ssm (`rwkv.py`), vlm (`vlm.py`)
and encdec (`encdec.py`). On a mesh `loss`, `prefill` and `decode` take
each rank's local shards of the params and caches (`models.params.
local_params`), on which every family computes, as XLA partitions the
reference's specs. Inputs may be tensors or arrays; arrays are placed on
the API's device, the CUDA card unless the caller asks for the CPU. `input_specs` gives the static buffers of the compiled steps
(`train/trainer.py` `jit_*`); `cache_pspecs` and `input_pspecs` their
specs on a mesh, the reference's, and `shardings_for` those specs fitted
to the shapes (non-divisible dims replicated).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.context import MeshCtx
from repro_torch.models.params import fit_spec, spec
from repro_torch.models.transformer import CacheSpec

DEC_PRIME = 448          # decoder token budget for enc-dec cells


@dataclasses.dataclass
class ModelAPI:
    cfg: ModelConfig
    device: DeviceLike = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def _m(self):
        fam = self.cfg.family
        if fam in ("dense", "moe"):
            from repro_torch.models import transformer as m
        elif fam == "hybrid":
            from repro_torch.models import recurrent as m
        elif fam == "ssm":
            from repro_torch.models import rwkv as m
        elif fam == "vlm":
            from repro_torch.models import vlm as m
        elif fam == "encdec":
            from repro_torch.models import encdec as m
        else:
            raise ValueError(fam)
        return m

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def param_defs(self):
        return self._m.param_defs(self.cfg)

    def loss(self, params, batch, mctx: MeshCtx):
        batch = {k: self._tensor(v) for k, v in batch.items()}
        return self._m.loss_fn(params, batch, self.cfg, mctx)

    def prefill(self, params, inputs: Dict[str, Any], mctx: MeshCtx):
        """Prefill on `tokens`, with the vlm's `vision_embeds` (B, N,
        d_vision) or the encdec's encoder `frames` (B, F, d_model)."""
        cfg, fam = self.cfg, self.cfg.family
        tokens = self._tensor(inputs["tokens"])
        if fam == "vlm":
            return self._m.prefill(params, tokens,
                                   self._tensor(inputs["vision_embeds"]),
                                   cfg, mctx)
        if fam == "encdec":
            return self._m.prefill(params, self._tensor(inputs["frames"]),
                                   tokens, cfg, mctx)
        return self._m.prefill(params, tokens, cfg, mctx)

    def decode(self, params, inputs: Dict[str, Any], cache, mctx: MeshCtx):
        """One decode step; the cache (or state) is updated in place and
        returned."""
        return self._m.decode_step(params, self._tensor(inputs["token"]),
                                   self._tensor(inputs["pos"]), cache,
                                   self.cfg, mctx)

    def cache_specs(self, batch: int, seq_len: int, dtype=None):
        """The KV caches of the dense, moe, vlm and encdec families in
        cfg.kv_cache_dtype, or the hybrid and ssm decode state (O(1) in
        seq_len) with its float32 and int32 leaves and the rest in
        bfloat16, unless `dtype` is given."""
        cfg, fam, m = self.cfg, self.cfg.family, self._m
        if fam in ("hybrid", "ssm"):
            return m.state_spec(cfg, batch,
                                torch.bfloat16 if dtype is None else dtype)
        if dtype is None:
            dtype = getattr(torch, cfg.kv_cache_dtype)
        if fam == "encdec":
            return m.cache_spec(cfg, batch, seq_len, cfg.encdec.n_frames,
                                dtype)
        return m.cache_spec(cfg, batch, seq_len, dtype)

    def cache_pspecs(self, mctx: MeshCtx):
        """Specs of `cache_specs`' leaves: the batch over the data axes,
        kv heads (or the recurrent width) over "model" where it divides;
        with `cache_seq_shard`, the sequence dim over "model" where the
        heads cannot take it (MLA's latent cache has no head dim)."""
        cfg, fam = self.cfg, self.cfg.family
        b = mctx.batch_axes
        tp = mctx.tp_size()

        def kh(n):
            return "model" if (tp > 1 and n % tp == 0) else None

        sq = self.cache_seq_axis(mctx)
        if fam in ("dense", "moe"):
            if cfg.mla is not None:
                return {"ckv": spec(None, b, sq, None),
                        "krope": spec(None, b, sq, None)}
            heads = kh(cfg.n_kv_heads)
            s = spec(None, b, sq, heads, None)
            return {"k": s, "v": s}
        if fam == "hybrid":
            r = kh(cfg.hybrid.d_rnn or cfg.d_model)
            kv = kh(cfg.n_kv_heads)
            out = {"super": {
                "rec": {"h": spec(None, None, b, r),
                        "conv": spec(None, None, b, None, r)},
                "attn": {"k": spec(None, b, None, kv, None),
                         "v": spec(None, b, None, kv, None),
                         "kpos": spec(None, b, None)}}}
            _, n_tail = self._m.pattern(cfg)
            out["tail"] = ({"h": spec(None, b, r),
                            "conv": spec(None, b, None, r)}
                           if n_tail else None)
            return out
        if fam == "ssm":
            h = kh(cfg.d_model // cfg.rwkv.head_dim)
            return {"tmix": {"shift": spec(None, b, None),
                             "s": spec(None, b, h, None, None)},
                    "cmix": {"shift": spec(None, b, None)}}
        heads = kh(cfg.n_kv_heads)
        if fam == "vlm":
            s = spec(None, None, b, sq, heads, None)
            c = spec(None, b, sq, heads, None)
            return {"self": {"k": s, "v": s}, "cross": {"k": c, "v": c}}
        if fam == "encdec":
            s = spec(None, b, sq, heads, None)
            return {"self": {"k": s, "v": s}, "cross": {"k": s, "v": s}}
        raise ValueError(fam)

    def cache_seq_axis(self, mctx: MeshCtx):
        """"model" where `cache_pspecs` shards the KV caches' sequence dim
        over it (`cache_seq_shard`, where the kv heads cannot take it, and
        MLA's latent cache, which has no head dim), else None. A rank
        computes on its local shards of every cache leaf, except where
        the sequence is sharded: there the cache is gathered along
        "model" and the rank's shard written back."""
        cfg = self.cfg
        if (cfg.family in ("hybrid", "ssm") or not cfg.cache_seq_shard
                or mctx.tp_size() <= 1):
            return None
        if cfg.mla is None and cfg.n_kv_heads % mctx.tp_size() == 0:
            return None
        return "model"

    def input_pspecs(self, mctx: MeshCtx, shape: ShapeConfig):
        """Specs of `input_specs(shape)`: every input's batch over the data
        axes, a decode step's cache by `cache_pspecs`."""
        fam = self.cfg.family
        b = mctx.batch_axes
        if shape.kind == "decode":
            return {"token": spec(b), "pos": spec(b),
                    "cache": self.cache_pspecs(mctx)}
        out = {"tokens": spec(b, None)}
        if shape.kind == "train":
            out["labels"] = spec(b, None)
        if fam == "vlm":
            out["vision_embeds"] = spec(b, None, None)
        if fam == "encdec":
            out["frames"] = spec(b, None, None)
        return out

    def input_specs(self, shape: ShapeConfig) -> Dict[str, Any]:
        """Shapes and dtypes of a step's inputs at `shape` (no
        allocation): tokens and labels to train, tokens to prefill (with
        the vlm's patch embeddings or the encdec's frames, and its
        DEC_PRIME decoder tokens), and the token, position and cache of a
        decode step against a seq_len cache."""
        cfg, fam = self.cfg, self.cfg.family
        B, S = shape.global_batch, shape.seq_len
        cdt = torch.bfloat16
        if shape.kind == "decode":
            return {"token": CacheSpec((B,), torch.int32),
                    "pos": CacheSpec((B,), torch.int32),
                    "cache": self.cache_specs(B, S)}
        if fam == "encdec":
            out = {"frames": CacheSpec((B, S, cfg.d_model), cdt),
                   "tokens": CacheSpec((B, DEC_PRIME), torch.int32)}
            tokens = (B, DEC_PRIME)
        else:
            out = {"tokens": CacheSpec((B, S), torch.int32)}
            tokens = (B, S)
        if fam == "vlm":
            out["vision_embeds"] = CacheSpec(
                (B, cfg.vlm.n_vision_tokens, cfg.vlm.d_vision), cdt)
        if shape.kind == "train":
            out["labels"] = CacheSpec(tokens, torch.int32)
        return out


def shardings_for(mesh, specs, pspecs):
    """The specs `pspecs` fitted to the shapes of `specs` (a tree of
    CacheSpecs or tensors): each dim the mesh axes do not divide is
    replicated. `models.params.placements` turns one into DTensor
    placements."""
    if isinstance(specs, dict):
        return {k: shardings_for(mesh, v, pspecs[k]) for k, v in specs.items()}
    if specs is None:
        return None
    return fit_spec(specs.shape, pspecs, mesh)
