"""llama-3.2-vision-11b [vlm] — cross-attention image layers.

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
[hf:meta-llama/Llama-3.2-11B-Vision]

The ViT vision encoder + projector is a STUB per the assignment carve-out:
input_specs() provides precomputed patch embeddings.  Cross-attention layers
are inserted every 5 decoder layers (8 total), matching the model card.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    arch_type="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500000.0,
    norm="rmsnorm",
    mlp="swiglu",
    vlm=VLMConfig(cross_attn_every=5, num_image_tokens=1601, image_embed_dim=1280),
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
