"""Architecture config registry.

``get_config(name)`` returns the full production config; ``get_smoke_config``
returns the reduced same-family variant used by CPU smoke tests.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (
    INPUT_SHAPES,
    EncDecConfig,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    VLMConfig,
    get_shape,
    reduced,
)

from repro_torch.configs.h2o_danube_3_4b import CONFIG as _h2o
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2
from repro_torch.configs.olmo_1b import CONFIG as _olmo
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _llama_vis
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as _granite_moe
from repro_torch.configs.granite_8b import CONFIG as _granite
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as _qwen3_moe
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.paper_gpt2_1_8b import CONFIG as _paper_gpt2

_REGISTRY: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        _h2o, _zamba2, _olmo, _whisper, _yi, _llama_vis,
        _granite_moe, _granite, _qwen3_moe, _mamba2, _paper_gpt2,
    )
}

# the 10 assigned architectures (paper-native gpt2 excluded)
ASSIGNED_ARCHS: List[str] = [
    "h2o-danube-3-4b", "zamba2-1.2b", "olmo-1b", "whisper-base", "yi-9b",
    "llama-3.2-vision-11b", "granite-moe-3b-a800m", "granite-8b",
    "qwen3-moe-30b-a3b", "mamba2-130m",
]


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; available: {list_archs()}")
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ModelConfig:
    return reduced(get_config(name))


__all__ = [
    "ASSIGNED_ARCHS", "INPUT_SHAPES", "EncDecConfig", "ModelConfig",
    "MoEConfig", "ShapeConfig", "SSMConfig", "TrainConfig", "VLMConfig",
    "get_config", "get_shape", "get_smoke_config", "list_archs", "reduced",
]
