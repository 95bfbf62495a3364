"""Central configuration system for the ROS2 port.

Every assigned architecture is described by a single `ModelConfig`; the
family field selects the model definition. Configs are plain frozen
dataclasses so they can be hashed and compared.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0              # routed experts
    top_k: int = 0
    n_shared: int = 0               # shared (always-on) experts
    d_ff_expert: int = 0            # per-expert hidden dim
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # §Perf hillclimb: all-to-all payload dtype for EP dispatch/return
    # ("bfloat16" baseline | "float8_e4m3fn" halves a2a wire bytes)
    dispatch_dtype: str = "bfloat16"


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2)."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma / Griffin-style hybrid."""
    d_rnn: int = 0                  # RG-LRU width (== d_model if 0)
    conv_width: int = 4
    attn_window: int = 2048         # local attention window
    # layer pattern: number of recurrent blocks per attention block
    rnn_per_attn: int = 2


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64            # lora rank for data-dependent decay
    mix_lora: int = 32              # lora rank for ddlerp token mixing


@dataclass(frozen=True)
class VLMConfig:
    n_vision_tokens: int = 4096     # stubbed precomputed patch embeddings
    d_vision: int = 1280            # frontend embedding width (projected in)
    cross_every: int = 5            # a cross-attn layer every Nth layer


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int = 4
    n_frames: int = 1500            # default stub frame count (overridable)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny"
    family: str = "dense"           # dense | moe | hybrid | ssm | vlm | encdec
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 32
    d_ff: int = 512
    vocab: int = 512
    act: str = "swiglu"             # swiglu | geglu | relu2 | gelu
    attn_impl: str = "jnp"          # jnp (chunked online-softmax) | flash
    #                               (CUDA kernel; prefill self-attn)
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = True
    max_seq: int = 8192             # advisory; caches sized by request
    # sub-configs (None when not applicable)
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    hybrid: Optional[HybridConfig] = None
    rwkv: Optional[RWKVConfig] = None
    vlm: Optional[VLMConfig] = None
    encdec: Optional[EncDecConfig] = None
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # training
    remat: bool = True
    zero1: bool = True              # shard optimizer moments over data axis
    fsdp: bool = False              # shard weights over data axis too (ZeRO-3)
    # §Perf hillclimb knobs (baselines keep the defaults)
    remat_policy: str = "nothing"   # "nothing" | "save_collectives": keep the
    #                               post-AR attn/ffn outputs so the backward
    #                               recompute skips the TP all-reduces
    kv_cache_dtype: str = "bfloat16"   # "float8_e4m3fn" halves decode cache
    cache_seq_shard: bool = False   # shard cache seq dim over "model" when
    #                               kv_heads don't divide tp (decode memory)
    # provenance
    source: str = ""

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    @property
    def d_head_total(self) -> int:
        return self.n_heads * self.head_dim

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND roofline."""
        d, v = self.d_model, self.vocab
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.family == "ssm":
            hd = self.rwkv.head_dim
            heads = d // hd
            # time-mix: r,k,v,g,o projections + decay/mix loras + ln params
            per_layer = 5 * d * d + d * self.rwkv.decay_lora * 2 \
                + 5 * d * self.rwkv.mix_lora * 2 + heads * hd \
                + 4 * d
            # channel mix
            per_layer += 2 * d * self.d_ff + self.d_ff * d if self.act in ("swiglu", "geglu") \
                else 2 * d * self.d_ff
            n += self.n_layers * per_layer
            return n
        # attention params
        if self.mla is not None:
            m = self.mla
            attn = d * m.q_lora_rank \
                + m.q_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim) \
                + d * (m.kv_lora_rank + m.qk_rope_head_dim) \
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim) \
                + self.n_heads * m.v_head_dim * d
        else:
            attn = d * self.n_heads * self.head_dim \
                + 2 * d * self.n_kv_heads * self.head_dim \
                + self.n_heads * self.head_dim * d
        # mlp params
        def mlp_params(dff: int) -> int:
            if self.act in ("swiglu", "geglu"):
                return 3 * d * dff
            return 2 * d * dff
        if self.family == "moe":
            mc = self.moe
            dense_ffn = (mc.n_experts + mc.n_shared) * mlp_params(mc.d_ff_expert) \
                + d * mc.n_experts
            per_layer = attn + dense_ffn
        elif self.family == "hybrid":
            h = self.hybrid
            d_rnn = h.d_rnn or d
            # recurrent block: in/out proj (x2 branches), conv, lru gates
            rec = 2 * d * d_rnn + d_rnn * d + h.conv_width * d_rnn + 2 * d_rnn * d_rnn + d_rnn
            per_attn = attn + 2 * mlp_params(self.d_ff)  # rough: each block has mlp
            # pattern: rnn_per_attn recurrent per 1 attention
            n_attn = self.n_layers // (h.rnn_per_attn + 1)
            n_rec = self.n_layers - n_attn
            n += n_rec * (rec + mlp_params(self.d_ff)) + n_attn * (attn + mlp_params(self.d_ff))
            return n
        else:
            per_layer = attn + mlp_params(self.d_ff)
        n += self.n_layers * per_layer
        return n

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k + shared only)."""
        if self.family != "moe":
            return self.n_params()
        mc = self.moe
        full = self.n_params()

        def mlp_params(dff: int) -> int:
            if self.act in ("swiglu", "geglu"):
                return 3 * self.d_model * dff
            return 2 * self.d_model * dff
        inactive = self.n_layers * (mc.n_experts - mc.top_k) * mlp_params(mc.d_ff_expert)
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)

SHAPE_BY_NAME = {s.name: s for s in SHAPES}

# Architectures with sub-quadratic sequence mixing (eligible for long_500k).
SUBQUADRATIC = ("recurrentgemma-2b", "rwkv6-1.6b")


def cell_is_runnable(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in SUBQUADRATIC
    return True


# ---------------------------------------------------------------------------
# Training hyperparams


@dataclass(frozen=True)
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    num_microbatches: int = 1
    grad_compression: str = "none"   # none | int8
    accum_dtype: str = "float32"     # §Perf: bfloat16 halves the live
    #                                gradient-accumulator footprint
    seed: int = 0
