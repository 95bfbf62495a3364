"""qwen3-14b [dense] — qk-norm, GQA kv=8. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936, act="swiglu", qk_norm=True,
    tie_embeddings=False, rope_theta=1e6, source="hf:Qwen/Qwen3-8B",
)
