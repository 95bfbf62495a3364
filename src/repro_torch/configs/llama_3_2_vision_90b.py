"""llama-3.2-vision-90b [vlm] — 100L with gated cross-attn every 5th layer;
stub patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from repro_torch.common.config import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab=128256, act="swiglu", tie_embeddings=False,
    rope_theta=500000.0, fsdp=True,
    vlm=VLMConfig(n_vision_tokens=4096, d_vision=1280, cross_every=5),
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
