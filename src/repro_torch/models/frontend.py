"""Modality frontend stubs (port of ``repro.models.frontend``).

The dense, MoE, SSM and hybrid families take tokens only.  The audio and VLM
families consume synthetic frame/patch embeddings; they are not ported yet
(ROADMAP M7.4).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ModelConfig


def synth_extra_inputs(cfg: ModelConfig, batch: int) -> Dict:
    """Synthetic modality inputs beside the tokens: none for the
    token-only families."""
    if cfg.arch_type in ("audio", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: inputs of arch_type {cfg.arch_type!r} are not "
            f"ported yet (ROADMAP M7.4)")
    return {}
