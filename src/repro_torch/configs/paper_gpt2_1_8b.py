"""paper-gpt2-1.8b — the paper's own 3D-parallel evaluation model (Table 2).

Singularity evaluates GPT-2 1.8B via Megatron-LM 3D parallelism.  We include
it as the paper-native config so the paper's experiments (device-proxy
overhead, splicing, migration) run on the model family the paper used.
Config follows Megatron GPT-2 scaled to ~1.8B params.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-gpt2-1.8b",
    arch_type="dense",
    num_layers=40,
    d_model=1920,
    num_heads=24,
    num_kv_heads=24,
    d_ff=7680,
    vocab_size=50304,
    norm="layernorm",
    mlp="gelu",
    tie_embeddings=True,
    source="Singularity paper Table 2 / arXiv:1909.08053",
)
