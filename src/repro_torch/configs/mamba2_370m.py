"""mamba2-370m [ssm] — 48L d1024, attention-free SSD (state-space duality),
ssm_state=128, vocab 50280.  [arXiv:2405.21060]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    tie_embeddings=True,
)
