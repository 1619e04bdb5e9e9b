"""Learning-rate schedules: warmup + cosine (port of
``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def lr_schedule(step, cfg: TrainConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor, whose device the
    result keeps), as an f32 scalar tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.learning_rate * warm * (0.1 + 0.9 * cos)
