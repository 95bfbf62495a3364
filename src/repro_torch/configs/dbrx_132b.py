"""dbrx-132b [moe] — 16 experts top-4, fine-grained GLU experts, GQA kv=8.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.common.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab=100352, act="swiglu", tie_embeddings=False,
    rope_theta=500000.0, fsdp=True,
    moe=MoEConfig(n_experts=16, top_k=4, n_shared=0, d_ff_expert=10752),
    source="hf:databricks/dbrx-base",
)
