"""deepseek-v2-236b [moe] — MLA (kv_lora=512), 2 shared + 160 routed experts
top-6. All layers MoE (the real model's first dense layer is folded in; see
DESIGN.md). [arXiv:2405.04434; hf]"""
from repro_torch.common.config import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=1536, vocab=102400, act="swiglu", tie_embeddings=False,
    rope_theta=10000.0, fsdp=True,
    moe=MoEConfig(n_experts=160, top_k=6, n_shared=2, d_ff_expert=1536),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    source="arXiv:2405.04434",
)
