"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64.
[arXiv:2411.15242]

Adaptation note (DESIGN.md §4): the shared attention block (single set of
weights, applied periodically — every 6th layer here) is the zamba2
signature.  The shared block uses a sliding window so long_500k decode is
sub-quadratic.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    arch_type="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    attn_every=6,
    shared_attn_block=True,
    sliding_window=4096,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, chunk_size=128),
    norm="rmsnorm",
    mlp="swiglu",
    source="arXiv:2411.15242",
)
