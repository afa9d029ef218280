"""granite-3-2b [dense] — 40L d2048 32H (kv=8) ff=8192 vocab 49155, GQA.
[hf:ibm-granite/granite-3.0-2b-base]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    d_ff=8192,
    vocab=49155,
)
