"""Shared layer primitives: norms, RoPE, initializers (port of
``repro.models.common``)."""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm(x: torch.Tensor, scale: Optional[torch.Tensor],
            eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    return x.to(dtype)


def layernorm(x: torch.Tensor, scale: Optional[torch.Tensor],
              bias: Optional[torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    if scale is not None:
        x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x.to(dtype)


def apply_norm(kind: str, x: torch.Tensor, params: Optional[dict],
               eps: float = 1e-6) -> torch.Tensor:
    """Dispatch on the config's norm kind; ``eps`` is the RMSNorm's (the
    LayerNorms keep 1e-5).

    ``nonparametric_ln`` (olmo, arXiv:2402.00838) is LayerNorm with no
    learned scale/bias: params is None.
    """
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"] if params else None, eps)
    if kind == "layernorm":
        return layernorm(x, params["scale"] if params else None,
                         params.get("bias") if params else None)
    if kind == "nonparametric_ln":
        return layernorm(x, None, None)
    raise ValueError(f"unknown norm {kind!r}")


def norm_param(kind: str, dim: int, *, device, dtype=torch.float32
               ) -> Optional[dict]:
    if kind == "rmsnorm":
        return {"scale": torch.ones(dim, device=device, dtype=dtype)}
    if kind == "layernorm":
        return {"scale": torch.ones(dim, device=device, dtype=dtype),
                "bias": torch.zeros(dim, device=device, dtype=dtype)}
    if kind == "nonparametric_ln":
        return None
    raise ValueError(kind)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """1 / theta^(2i / head_dim) in f64, as the JAX package computes them in
    numpy; made on ``device``, so no host-to-device copy (which would wait
    for the card) sits in every layer."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float64,
                            device=device) / head_dim
    return 1.0 / theta ** exponent


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Split-half rotary embedding (not the interleaved form).

    x: (..., seq, heads, head_dim); positions: (..., seq) integers.
    """
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device).float()
    angles = positions[..., None].float() * freqs     # (..., seq, hd/2)
    angles = angles[..., None, :]                     # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)


def dense_init(gen: torch.Generator, shape, scale: float = 0.02, *,
               device, dtype=torch.float32) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in f32 from ``gen`` on ``device``."""
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return (scale * w).to(dtype)
