"""Trip-count-aware analytic roofline model, the counterpart of
`repro/roofline/analytic.py`: the same terms and formulas, keyed by the
same `detail` names, on the port's `common/config.py`; `Terms.seconds()`
divides by one NVIDIA H100 SXM's peaks (`launch/mesh.py`) instead of the
TPU v5e's.

Why this exists: XLA's `compiled.cost_analysis()` and the HLO text both
count ops inside `while` bodies (lax.scan over layers / microbatches)
ONCE, so parsed totals underestimate real per-step work by the trip
count. The port's dry-run traces every iteration of its Python loops, so
its counts are totals, but of what the port runs (params gathered whole
on every rank, no dense tensor parallelism), not of the sharded schedule
this module assumes. The three roofline terms:

    compute_s    = FLOPs_dev / PEAK_FLOPS
    memory_s     = HBM_bytes_dev / HBM_BW
    collective_s = wire_bytes_dev / ICI_BW

All quantities are per device per step. Formulas are deliberately explicit
and component-labelled so each hillclimb hypothesis can be napkin-mathed
against a single term.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.common.config import ModelConfig, ShapeConfig
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

# NVIDIA H100 SXM, per card (launch/mesh.py)
PEAK_FLOPS = PEAK_FLOPS_BF16   # bf16 FLOP/s
ICI_BW = NVLINK_BW             # B/s per card, each way (link bw)

CDT = 2                        # compute dtype bytes (bf16)
F32 = 4


@dataclass
class MeshPlan:
    dp: int = 16               # data-parallel ways (pod*data)
    tp: int = 16               # tensor-parallel ways (model axis)

    @property
    def n_dev(self) -> int:
        return self.dp * self.tp


@dataclass
class Terms:
    flops_dev: float = 0.0
    hbm_dev: float = 0.0
    coll_dev: float = 0.0
    detail: Dict[str, float] = field(default_factory=dict)

    def seconds(self) -> Dict[str, float]:
        comp = self.flops_dev / PEAK_FLOPS
        mem = self.hbm_dev / HBM_BW
        coll = self.coll_dev / ICI_BW
        dom = max(("compute", comp), ("memory", mem),
                  ("collective", coll), key=lambda kv: kv[1])
        bound = max(comp, mem, coll)
        return {"compute_s": comp, "memory_s": mem, "collective_s": coll,
                "dominant": dom[0],
                "roofline_frac": comp / bound if bound > 0 else 1.0}


def _div(dim: int, ways: int) -> int:
    """Sharding degree actually achieved (replicate if not divisible)."""
    return ways if ways > 1 and dim % ways == 0 else 1


def _ring_ar(nbytes: float, n: int) -> float:
    return 2.0 * nbytes * (n - 1) / n if n > 1 else 0.0


def _ring_ag(nbytes: float, n: int) -> float:
    return nbytes * (n - 1) / n if n > 1 else 0.0


def _ring_a2a(nbytes: float, n: int) -> float:
    return nbytes * (n - 1) / n if n > 1 else 0.0


def _param_bytes(cfg: ModelConfig) -> int:
    return cfg.n_params() * (2 if cfg.param_dtype == "bfloat16" else 4)


def _layers_attn(cfg: ModelConfig):
    """(n_self_attn_layers, n_cross_layers, n_rec_layers, n_other)."""
    L = cfg.n_layers
    if cfg.family == "hybrid":
        per = cfg.hybrid.rnn_per_attn + 1
        n_attn = L // per
        return n_attn, 0, L - n_attn, 0
    if cfg.family == "vlm":
        n_cross = L // cfg.vlm.cross_every
        return L - n_cross, n_cross, 0, 0
    if cfg.family == "encdec":
        return L, L, 0, cfg.encdec.n_enc_layers   # dec self + dec cross; enc
    if cfg.family == "ssm":
        return 0, 0, L, 0
    return L, 0, 0, 0


def _attn_dims(cfg: ModelConfig):
    if cfg.mla is not None:
        h = cfg.n_heads
        d_qk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        return h, d_qk, cfg.mla.v_head_dim
    return cfg.n_heads, cfg.head_dim, cfg.head_dim


def _seq_flops_token(cfg: ModelConfig, s_eff: float) -> float:
    """S-dependent attention FLOPs per token (qk^T + pv), per self-attn
    layer; 2 matmuls x 2 FLOP/MAC."""
    h, d_qk, d_v = _attn_dims(cfg)
    return 2.0 * h * (d_qk + d_v) * s_eff


def _cache_bytes_token(cfg: ModelConfig, S: int) -> float:
    """KV/state bytes one decode step must read, whole model."""
    n_self, n_cross, n_rec, n_enc = _layers_attn(cfg)
    kv_b = 1 if "float8" in cfg.kv_cache_dtype else CDT
    if cfg.family == "ssm":
        hd = cfg.rwkv.head_dim
        heads = cfg.d_model // hd
        return cfg.n_layers * heads * hd * hd * F32      # matrix state
    if cfg.mla is not None:
        per_tok = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        return n_self * S * per_tok * kv_b
    kv = 2 * cfg.n_kv_heads * cfg.head_dim * kv_b
    out = n_self * S * kv
    if cfg.family == "hybrid":
        W = min(cfg.hybrid.attn_window, S)
        r = cfg.hybrid.d_rnn or cfg.d_model
        out = n_self * W * kv + n_rec * r * (F32 + (cfg.hybrid.conv_width - 1) * CDT)
    if n_cross:
        S_kv = (cfg.vlm.n_vision_tokens if cfg.family == "vlm"
                else cfg.encdec.n_frames)
        out += n_cross * S_kv * kv
    return out


# ---------------------------------------------------------------------------
# per-layer collective schedule (what the TP sharding implies)


def _tp_collectives_per_layer(cfg: ModelConfig, plan: MeshPlan,
                              tokens_mb: float) -> float:
    """Wire bytes per device for ONE forward pass of one microbatch across
    all layers: the residual-stream all-reduces TP inserts."""
    tp = plan.tp
    if tp <= 1:
        return 0.0
    act = tokens_mb * cfg.d_model * CDT          # one residual activation
    n_self, n_cross, n_rec, n_enc = _layers_attn(cfg)
    # each block: mixer output AR + mlp output AR
    n_ar = 2 * (n_self + n_rec) + n_cross + n_enc * 2
    wire = n_ar * _ring_ar(act / plan.dp, tp)    # act is already per-dp slice
    if cfg.family == "moe":
        mc = cfg.moe
        ep = _div(mc.n_experts, tp)
        ddt = 1 if "float8" in mc.dispatch_dtype else CDT
        # dispatch + return all-to-all of the top-k expanded tokens
        a2a = tokens_mb / plan.dp * mc.top_k * cfg.d_model * ddt
        wire += cfg.n_layers * 2 * _ring_a2a(a2a, ep)
    return wire


def _logit_bytes(cfg: ModelConfig, tokens_dev: float) -> float:
    v_shard = cfg.vocab // _div(cfg.vocab, 16)
    return tokens_dev * v_shard * F32


# ---------------------------------------------------------------------------
# public: per-(cfg, shape, plan) terms


def train_terms(cfg: ModelConfig, shape: ShapeConfig, plan: MeshPlan,
                nmb: int = 8) -> Terms:
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    tokens_dev = tokens / plan.dp               # model-axis replicates tokens
    n = plan.n_dev
    N = cfg.n_active_params()
    P = _param_bytes(cfg)
    t = Terms()

    # ---- compute: 2N fwd + 4N bwd + 2N remat recompute (cfg.remat) --------
    mm_factor = 8.0 if cfg.remat else 6.0
    t.detail["flops_matmul"] = mm_factor * N * tokens / n
    n_self, n_cross, *_ = _layers_attn(cfg)
    s_eff_self = S / 2                          # causal average
    attn_fwd = tokens * (n_self * _seq_flops_token(cfg, s_eff_self))
    if n_cross:
        s_kv = (cfg.vlm.n_vision_tokens if cfg.family == "vlm"
                else cfg.encdec.n_frames)
        attn_fwd += tokens * n_cross * _seq_flops_token(cfg, s_kv)
    t.detail["flops_attn"] = (4.0 if cfg.remat else 3.0) * attn_fwd / n
    t.flops_dev = t.detail["flops_matmul"] + t.detail["flops_attn"]

    # ---- HBM bytes ---------------------------------------------------------
    shard_p = _div(cfg.d_ff, plan.tp)               # bulk params shard tp-way
    P_dev = P / shard_p
    G_dev = N * F32 / shard_p
    B_mb = tokens_dev / nmb                          # tokens per microbatch
    # nothing_saveable keeps 1 tensor per layer (the block input);
    # save_collectives keeps 3 (input + post-AR attn/ffn outputs)
    n_saved = 3.0 if cfg.remat_policy == "save_collectives" else 1.0
    acts = 4.0 * n_saved * cfg.n_layers * B_mb * cfg.d_model * CDT
    t.detail["hbm_params"] = 3.0 * P_dev * nmb       # fwd + recompute + bwd
    t.detail["hbm_grads"] = 2.0 * G_dev * nmb        # accumulate r+w
    t.detail["hbm_opt"] = 16.0 * N / shard_p / plan.dp + P_dev  # m,v rw + p w
    t.detail["hbm_acts"] = acts * nmb
    t.detail["hbm_logits"] = 2.0 * _logit_bytes(cfg, tokens_dev)
    t.hbm_dev = sum(v for k, v in t.detail.items() if k.startswith("hbm"))

    # ---- collectives -------------------------------------------------------
    # _tp_collectives_per_layer already folds the dp split of tokens, so the
    # sum over microbatches equals one full-batch forward's wire bytes;
    # bwd doubles it and remat recompute adds one more forward — unless the
    # save_collectives policy keeps the post-AR outputs.
    fwd_wire = _tp_collectives_per_layer(cfg, plan, tokens)
    redo_coll = cfg.remat and cfg.remat_policy != "save_collectives"
    t.detail["coll_tp"] = (3.0 if redo_coll else 2.0) * fwd_wire
    # ZeRO-1 DP gradient reduce-scatter + param all-gather
    t.detail["coll_dp"] = (_ring_ag(G_dev, plan.dp)          # reduce-scatter
                           + _ring_ag(P_dev, plan.dp))       # param gather
    t.coll_dev = t.detail["coll_tp"] + t.detail["coll_dp"]
    return t


def prefill_terms(cfg: ModelConfig, shape: ShapeConfig,
                  plan: MeshPlan) -> Terms:
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S
    n = plan.n_dev
    N = cfg.n_active_params()
    t = Terms()
    n_self, n_cross, *_ = _layers_attn(cfg)
    s_eff = min(cfg.hybrid.attn_window, S) if cfg.family == "hybrid" \
        else S / 2
    attn = tokens * n_self * _seq_flops_token(cfg, s_eff)
    if n_cross:
        s_kv = (cfg.vlm.n_vision_tokens if cfg.family == "vlm"
                else cfg.encdec.n_frames)
        attn += tokens * n_cross * _seq_flops_token(cfg, s_kv)
    t.detail["flops_matmul"] = 2.0 * N * tokens / n
    t.detail["flops_attn"] = attn / n
    t.flops_dev = t.detail["flops_matmul"] + t.detail["flops_attn"]
    shard_p = plan.tp
    t.detail["hbm_params"] = _param_bytes(cfg) / shard_p
    t.detail["hbm_acts"] = 4.0 * cfg.n_layers * tokens / plan.dp \
        * cfg.d_model * CDT
    t.detail["hbm_cache_w"] = B * _cache_bytes_token(cfg, S) / n
    t.hbm_dev = sum(v for k, v in t.detail.items() if k.startswith("hbm"))
    t.detail["coll_tp"] = _tp_collectives_per_layer(cfg, plan, tokens)
    t.coll_dev = t.detail["coll_tp"]
    return t


def decode_terms(cfg: ModelConfig, shape: ShapeConfig,
                 plan: MeshPlan) -> Terms:
    B, S = shape.global_batch, shape.seq_len
    n = plan.n_dev
    N = cfg.n_active_params()
    t = Terms()
    n_self, n_cross, *_ = _layers_attn(cfg)
    s_eff = min(cfg.hybrid.attn_window, S) if cfg.family == "hybrid" else S
    attn = B * n_self * _seq_flops_token(cfg, s_eff)
    t.detail["flops_matmul"] = 2.0 * N * B / n
    t.detail["flops_attn"] = attn / n
    t.flops_dev = t.detail["flops_matmul"] + t.detail["flops_attn"]
    # params stream once; the whole cache streams once. The cache shards
    # over batch (dp) and — when head count divides — kv heads (tp); MLA's
    # single latent head and MQA (kv=1) replicate over tp.
    cache = B * _cache_bytes_token(cfg, S)
    cache_shards = _div(B, plan.dp) * _div(cfg.n_kv_heads, plan.tp)
    if cfg.cache_seq_shard and _div(cfg.n_kv_heads, plan.tp) == 1:
        cache_shards = _div(B, plan.dp) * _div(S, plan.tp)   # §Perf variant
    if cfg.family in ("ssm", "hybrid"):
        # recurrent state shards over its channel dim instead of heads
        cache_shards = _div(B, plan.dp) * plan.tp
    t.detail["hbm_params"] = _param_bytes(cfg) / plan.tp
    t.detail["hbm_cache"] = cache / cache_shards
    t.hbm_dev = t.detail["hbm_params"] + t.detail["hbm_cache"]
    t.detail["coll_tp"] = _tp_collectives_per_layer(cfg, plan, B)
    t.coll_dev = t.detail["coll_tp"]
    return t


def terms_for(cfg: ModelConfig, shape: ShapeConfig, plan: MeshPlan,
              nmb: int = 8) -> Terms:
    if shape.kind == "train":
        return train_terms(cfg, shape, plan, nmb)
    if shape.kind == "prefill":
        return prefill_terms(cfg, shape, plan)
    return decode_terms(cfg, shape, plan)


def model_flops_per_step(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE); decode counts one
    token per sequence; prefill counts 2ND (forward only)."""
    if shape.kind == "train":
        per_tok = 6.0 * cfg.n_active_params()
        toks = shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        per_tok = 2.0 * cfg.n_active_params()
        toks = shape.global_batch * shape.seq_len
    else:
        per_tok = 2.0 * cfg.n_active_params()
        toks = shape.global_batch
    return per_tok * toks
