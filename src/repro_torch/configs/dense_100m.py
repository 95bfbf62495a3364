"""~100M-parameter dense LM for the end-to-end example driver
(examples/train_100m_ros2.py). GPT-2-small-like geometry with the
framework's modern defaults (RMSNorm, RoPE, SwiGLU, GQA)."""
from repro_torch.common.config import ModelConfig

CONFIG = ModelConfig(
    name="dense-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab=32000,
    act="swiglu",
    tie_embeddings=True,
    remat=False,                  # small model; full activations fit
    source="example driver config (~100M params)",
)
