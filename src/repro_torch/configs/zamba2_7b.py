"""zamba2-7b [hybrid] — 81 Mamba2 blocks d3584 + 2 alternating *shared*
attention blocks (32H, kv=32, ff=14336) applied every 6 mamba blocks,
ssm_state=64, vocab 32000.  [arXiv:2411.15242]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    shared_every=6,
    n_shared=2,
)
