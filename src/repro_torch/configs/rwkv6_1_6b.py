"""rwkv6-1.6b "Finch" [ssm] — attention-free, data-dependent decay.
Sub-quadratic: runs long_500k. [arXiv:2404.05892; unverified]"""
from repro_torch.common.config import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536, act="relu2", tie_embeddings=True,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
    source="arXiv:2404.05892",
)
