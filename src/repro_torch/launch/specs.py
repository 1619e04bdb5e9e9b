"""Abstract input and state specs for every (arch x shape) pair (port of
``repro.launch.specs``).

These are the dry-run stand-ins: tensors on the ``meta`` device, with
shapes and dtypes and no storage, never allocated.  ``input_specs`` covers
the model inputs (tokens/labels plus the stubbed modality embeddings);
``state_specs`` and ``decode_specs`` the train and serve state trees.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (ModelConfig, ShapeConfig, TrainConfig,
                                      get_shape)
from repro_torch.models import init_decode_state
from repro_torch.models.frontend import extra_inputs_spec
from repro_torch.training.state import init_train_state

SWA_VARIANT_WINDOW = 4096
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class PairPlan:
    """What a given (arch, shape) pair lowers."""
    cfg: ModelConfig
    shape: ShapeConfig
    kind: str                 # train | prefill | decode
    swa_variant: bool         # dense arch long-context via documented SWA
    skip_reason: Optional[str] = None


def plan_pair(arch: str, shape_name: str) -> PairPlan:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    swa_variant = False
    skip = None
    if shape.name == "long_500k":
        if cfg.arch_type == "audio":
            skip = ("enc-dec decoder semantics cap at encoder-conditioned "
                    "transcription; 524k-token decode is meaningless "
                    "(DESIGN.md §4)")
        elif cfg.arch_type in ("ssm",):
            pass                      # recurrent state: natively O(1)
        elif cfg.sliding_window:
            pass                      # native SWA (danube, zamba2 shared blk)
        else:
            # dense/moe/vlm: documented sliding-window variant
            cfg = dataclasses.replace(cfg, sliding_window=SWA_VARIANT_WINDOW)
            swa_variant = True
    return PairPlan(cfg=cfg, shape=shape, kind=shape.kind,
                    swa_variant=swa_variant, skip_reason=skip)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                device=META) -> Dict[str, torch.Tensor]:
    """The batch consumed by train/prefill steps (token ids as int64, the
    port's index dtype, where JAX's are int32), or decode's one token per
    sequence."""
    g, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": torch.empty((g,), dtype=torch.long, device=device)}
    specs = {"tokens": torch.empty((g, s), dtype=torch.long, device=device)}
    if shape.kind == "train":
        specs["labels"] = torch.empty((g, s), dtype=torch.long,
                                      device=device)
    for name, (shp, dt) in extra_inputs_spec(cfg, g,
                                             dtype=torch.bfloat16).items():
        specs[name] = torch.empty(shp, dtype=dt, device=device)
    return specs


def state_specs(cfg: ModelConfig, tcfg: TrainConfig, device=META):
    """The train state (f32 params, AdamW moments, count, step) on
    ``device``: with ``meta``, no memory at any size."""
    return init_train_state(cfg, tcfg, device=device)


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, device=META):
    """The decode state (KV/SSM caches at seq_len) on ``device``."""
    return init_decode_state(cfg, shape.global_batch, shape.seq_len,
                             device=device, dtype=torch.bfloat16)
