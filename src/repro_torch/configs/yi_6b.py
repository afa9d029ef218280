"""yi-6b [dense] — 32L d4096 32H (kv=4) ff=11008 vocab 64000, llama-arch GQA.
[arXiv:2403.04652]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab=64000,
)
