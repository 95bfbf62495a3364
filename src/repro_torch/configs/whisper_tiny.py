"""whisper-tiny [audio] — enc-dec backbone; conv frontend STUB (precomputed
frame embeddings). 4 encoder + 4 decoder layers. [arXiv:2212.04356;
unverified]"""
from repro_torch.common.config import ModelConfig, EncDecConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6, head_dim=64,
    d_ff=1536, vocab=51865, act="gelu", tie_embeddings=True,
    encdec=EncDecConfig(n_enc_layers=4, n_frames=1500),
    source="arXiv:2212.04356",
)
