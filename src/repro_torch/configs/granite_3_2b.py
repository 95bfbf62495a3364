"""granite-3-2b [dense] — GQA kv=8. [hf:ibm-granite/granite-3.0-2b-base; hf]"""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=49155, act="swiglu", tie_embeddings=True,
    rope_theta=10000.0, source="hf:ibm-granite/granite-3.0-2b-base",
)
