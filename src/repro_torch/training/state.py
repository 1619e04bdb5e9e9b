"""Training state: the complete, checkpointable program state of a job
(port of ``repro.training.state``).

The state is this tree plus the data pipeline's cursor: f32 master
parameters, the AdamW moments and count, and the step.  Captured at a step
boundary it is exactly work-conserving.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models.model import check_trainable, init_params
from repro_torch.optim.adamw import adamw_init

TrainState = Dict[str, Any]


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, seed: int = 0, *,
                     device) -> TrainState:
    """f32 parameters from ``seed`` (as JAX's ``init_params`` default), zero
    AdamW moments, step 0 (an int32 scalar on ``device``)."""
    check_trainable(cfg)
    params = init_params(cfg, seed, device=device, dtype=torch.float32)
    return {"params": params, "opt": adamw_init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}
