"""Architecture registry: full (assigned) configs + reduced tiny variants."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.common.config import (
    EncDecConfig, HybridConfig, MLAConfig, ModelConfig, MoEConfig, RWKVConfig,
)

_MODULES = {
    "gemma-7b": "gemma_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-14b": "qwen3_14b",
    "granite-3-2b": "granite_3_2b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-tiny": "whisper_tiny",
    "dbrx-132b": "dbrx_132b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "rwkv6-1.6b": "rwkv6_1_6b",
}

# extra configs that are not part of the assigned pool (example drivers)
_EXTRA = {
    "dense-100m": "dense_100m",
}

ARCHS = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name.startswith("tiny-"):
        return tiny_config(name[len("tiny-"):])
    mod_name = _MODULES.get(name) or _EXTRA[name]
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def tiny_config(name: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    full = get_config(name)
    common = dict(name=f"tiny-{name}", d_model=64, d_ff=128, vocab=512,
                  param_dtype="float32", compute_dtype="float32")
    if full.family == "dense":
        return full.replace(n_layers=2, n_heads=4,
                            n_kv_heads=min(full.n_kv_heads, 2), head_dim=16,
                            **common)
    if full.family == "moe":
        mla = None
        if full.mla is not None:
            mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                            qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16)
        return full.replace(
            n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16, fsdp=False,
            moe=MoEConfig(n_experts=4, top_k=min(full.moe.top_k, 2),
                          n_shared=full.moe.n_shared and 1, d_ff_expert=64),
            mla=mla, **common)
    if full.family == "hybrid":
        return full.replace(
            n_layers=5, n_heads=4, n_kv_heads=1, head_dim=16,
            hybrid=HybridConfig(d_rnn=96, conv_width=4, attn_window=16,
                                rnn_per_attn=2), **common)
    if full.family == "ssm":
        return full.replace(
            n_layers=2, rwkv=RWKVConfig(head_dim=16, decay_lora=8, mix_lora=8),
            **common)
    if full.family == "vlm":
        from repro_torch.common.config import VLMConfig
        return full.replace(
            n_layers=4, n_heads=4, n_kv_heads=2, head_dim=16, fsdp=False,
            vlm=VLMConfig(n_vision_tokens=16, d_vision=32, cross_every=2),
            **common)
    if full.family == "encdec":
        return full.replace(
            n_layers=2, n_heads=4, n_kv_heads=4, head_dim=16,
            encdec=EncDecConfig(n_enc_layers=2, n_frames=24), **common)
    raise ValueError(full.family)
