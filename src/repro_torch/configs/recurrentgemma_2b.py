"""recurrentgemma-2b [hybrid] — RG-LRU + local attention 1:2, MQA (kv=1),
window 2048. Sub-quadratic: runs long_500k. [arXiv:2402.19427; hf]"""
from repro_torch.common.config import ModelConfig, HybridConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256000, act="geglu", tie_embeddings=True,
    rope_theta=10000.0,
    hybrid=HybridConfig(d_rnn=2560, conv_width=4, attn_window=2048,
                        rnn_per_attn=2),
    source="arXiv:2402.19427",
)
