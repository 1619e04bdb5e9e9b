"""Modality frontend stubs (port of ``repro.models.frontend``).

The audio and VLM architectures specify the transformer backbone only;
the mel-spectrogram + conv codec and the ViT vision encoder are stubs:
these helpers give the shapes of (or draw) precomputed frame and patch
embeddings.  The other families take tokens only.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig


def extra_inputs_spec(cfg: ModelConfig, batch: int,
                      dtype=torch.bfloat16) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """{name: (shape, dtype)} of the modality inputs the backbone takes:
    ``image_embeds`` (B, image tokens, image width) for vlm,
    ``encoder_frames`` (B, encoder frames, d_model) for audio."""
    if cfg.arch_type == "vlm":
        return {"image_embeds": ((batch, cfg.vlm.num_image_tokens,
                                  cfg.vlm.image_embed_dim), dtype)}
    if cfg.arch_type == "audio":
        return {"encoder_frames": ((batch, cfg.encdec.encoder_seq,
                                    cfg.d_model), dtype)}
    return {}


def synth_extra_inputs(cfg: ModelConfig, batch: int, seed: int = 0, *,
                       device="cpu", dtype=torch.float32) -> Dict:
    """Synthetic embeddings, 0.02 * N(0, 1) drawn in f32 from a
    ``torch.Generator`` seeded with ``seed``, then cast to ``dtype`` and
    put on ``device``, as the JAX function draws them from its key (the
    values differ: the two frameworks draw other random numbers).  They
    are drawn on the CPU, so that every device gets the same values."""
    specs = extra_inputs_spec(cfg, batch, dtype)
    if not specs:
        return {}
    gen = torch.Generator().manual_seed(seed)
    return {name: (0.02 * torch.randn(shape, generator=gen,
                                      dtype=torch.float32)).to(
                                          device=device, dtype=dt)
            for name, (shape, dt) in specs.items()}
