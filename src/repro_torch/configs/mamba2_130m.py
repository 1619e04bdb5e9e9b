"""mamba2-130m [ssm] — SSD (state-space duality), attention-free.

24L d_model=768 vocab=50280, ssm_state=128.  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    arch_type="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,               # attention-free
    num_kv_heads=0,
    d_ff=0,                    # no separate MLP; SSD block has internal expand
    vocab_size=50280,
    norm="rmsnorm",
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=128),
    source="arXiv:2405.21060",
)
