"""internvl2-1b [vlm] — 24L d896 14H (kv=2) ff=4864 vocab 151655.
InternViT frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings (B, n_patches, d_model); the assigned backbone (Qwen2-0.5B-like)
is implemented in full.  [arXiv:2404.16821]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab=151655,
    n_patches=1024,
)
