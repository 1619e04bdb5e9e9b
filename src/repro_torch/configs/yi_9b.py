"""yi-9b [dense] — llama-arch with aggressive GQA.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.  [arXiv:2403.04652]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    arch_type="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    norm="rmsnorm",
    mlp="swiglu",
    source="arXiv:2403.04652",
)
