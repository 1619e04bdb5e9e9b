"""Feed-forward layers: SwiGLU and GELU MLPs (port of ``repro.models.mlp``).

Under a mesh the hidden activations are pinned over "model" (column- then
row-parallel, Megatron's layout) and the output over the batch axes, as
JAX's constraints do; outside a mesh the constraints are no-ops."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models.common import dense_init
from repro_torch.parallel.constraints import BATCH, MODEL, constrain


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str, *,
             device, dtype=torch.float32) -> Dict:
    out_scale = 0.02 / math.sqrt(2.0)
    if kind == "swiglu":
        return {
            "wi": dense_init(gen, (d_model, d_ff), device=device, dtype=dtype),
            "wg": dense_init(gen, (d_model, d_ff), device=device, dtype=dtype),
            "wo": dense_init(gen, (d_ff, d_model), scale=out_scale,
                             device=device, dtype=dtype),
        }
    if kind == "gelu":
        return {
            "wi": dense_init(gen, (d_model, d_ff), device=device, dtype=dtype),
            "wo": dense_init(gen, (d_ff, d_model), scale=out_scale,
                             device=device, dtype=dtype),
        }
    raise ValueError(f"unknown mlp kind {kind!r}")


def mlp_forward(params: Dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = x @ params["wi"].to(x.dtype)
        g = x @ params["wg"].to(x.dtype)
        h = F.silu(g) * constrain(h, BATCH, None, MODEL)
    elif kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(constrain(x @ params["wi"].to(x.dtype), BATCH, None, MODEL),
                   approximate="tanh")
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return constrain(h @ params["wo"].to(x.dtype), BATCH, None, None)
