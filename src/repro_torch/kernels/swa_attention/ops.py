"""Public sliding-window attention op (port of
``repro.kernels.swa_attention.ops``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.swa_attention.ref import swa_attention_ref
from repro_torch.kernels.swa_attention.swa import swa_flash


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention.

    q, k, v: (B, S, H, D), kv heads already repeated to H (GQA is the
    caller's).  Returns (B, S, H, D).  CPU tensors take the plain version;
    any other tensor goes to the CUDA kernel, which launches or raises.
    """
    if q.device.type == "cpu":
        out = swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), window=window)
        return out.transpose(1, 2)
    return swa_flash(q, k, v, window=window)
