"""qwen3-moe-30b-a3b [moe] — 48L d2048 32H (kv=4) per-expert ff=768, vocab 151936,
MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,          # per-expert hidden dim
    vocab=151936,
    n_experts=128,
    topk=8,
    moe_mode="dispatch",
    expert_pad=16,
)
