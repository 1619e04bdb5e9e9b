"""granite-moe-3b-a800m [moe] — 40 experts, top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512(per-expert) vocab=49155, MoE 40e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                  # per-expert FFN width
    vocab_size=49155,
    norm="rmsnorm",
    mlp="swiglu",
    moe=MoEConfig(num_experts=40, top_k=8),
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
