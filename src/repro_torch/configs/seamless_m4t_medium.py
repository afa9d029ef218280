"""seamless-m4t-medium [audio] — enc-dec, 12L encoder + 12L decoder, d1024 16H
(kv=16 = MHA) ff=4096 vocab 256206.  The speech frontend is a STUB:
``input_specs()`` provides precomputed frame embeddings (B, S, d_model).
[arXiv:2308.11596]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,      # decoder depth
    enc_layers=12,    # encoder depth
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
)
