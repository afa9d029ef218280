"""zamba2-7b-instruct [hybrid] — Zyphra/Zamba2-7B-Instruct as published
(``config.json``; arXiv:2411.15242): 81 Mamba2 layers d3584 (112 heads of
64, state 64, 2 B/C groups), 13 of them hybrid (``hybrid_layer_ids``),
each first applying one of 2 alternating shared blocks: the concatenation
[x, embeddings] (7168 wide) through 32 heads of 224 with full rotary and
softmax scale (224/2)^-1/2, then a GELU-gated MLP (ffn 14336) whose
gate/up carries the application's own rank-128 adapter, then the
application's own ``linear`` into the Mamba block's input.  Vocab 32000,
tied embeddings (``Zamba2Config``'s default)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b-instruct",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=224,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_groups=2,
    n_shared=2,
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    adapter_rank=128,
    attn_scale=(224 / 2) ** -0.5,
    tie_embeddings=True,
)
