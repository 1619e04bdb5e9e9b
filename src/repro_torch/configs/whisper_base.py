"""whisper-base [audio] — encoder-decoder transformer backbone.

6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865.  [arXiv:2212.04356]

The mel-spectrogram + conv feature extractor frontend is a STUB per the
assignment carve-out: input_specs() provides precomputed frame embeddings
of shape (batch, 1500, 512).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    arch_type="audio",
    num_layers=6,              # decoder layers
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    norm="layernorm",
    mlp="gelu",
    encdec=EncDecConfig(encoder_layers=6, encoder_seq=1500),
    source="arXiv:2212.04356",
)
