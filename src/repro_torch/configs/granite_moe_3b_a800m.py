"""granite-moe-3b-a800m [moe] — 32L d1536 24H (kv=8) per-expert ff=512, vocab 49155,
MoE 40 experts top-8.  [hf:ibm-granite/granite-3.0-3b-a800m-base family].

Note: the assignment text says both "MoE 40e top-8" and "32 experts top-8";
the 3b-a800m member of the Granite-3.0 family uses 40 experts, so we use 40.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,          # per-expert hidden dim
    vocab=49155,
    n_experts=40,
    topk=8,
    moe_mode="dispatch",
    expert_pad=16,
)
