"""gemma-7b [dense] — GeGLU, head_dim=256, GQA kv=16 (== MHA at 16 heads).
[arXiv:2403.08295; hf]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="geglu", tie_embeddings=True,
    rope_theta=10000.0, source="arXiv:2403.08295",
)
