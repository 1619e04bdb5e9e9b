"""olmo-1b [dense] — non-parametric LayerNorm.

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.  [arXiv:2402.00838]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    arch_type="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm="nonparametric_ln",   # olmo signature: LN without scale/bias params
    mlp="swiglu",
    tie_embeddings=True,
    source="arXiv:2402.00838",
)
