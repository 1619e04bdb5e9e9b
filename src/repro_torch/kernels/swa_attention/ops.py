"""Public sliding-window attention op (port of
``repro.kernels.swa_attention.ops``), with its gradient."""
from __future__ import annotations

import torch

from repro_torch.kernels.swa_attention.ref import (swa_attention_bwd_ref,
                                                   swa_attention_ref)
from repro_torch.kernels.swa_attention.swa import swa_flash


class _SwaAttention(torch.autograd.Function):
    """Forward: ``swa_flash`` on CUDA tensors, the plain version on CPU
    tensors.  Backward: plain torch (``swa_attention_bwd_ref``) on both.
    The kernel's output carries no graph of its own, so without this
    Function a card run would give q, k and v no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        if q.device.type == "cpu":
            out = swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                    v.transpose(1, 2), window=window)
            return out.transpose(1, 2)
        return swa_flash(q, k, v, window=window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*swa_attention_bwd_ref(q, k, v, do, ctx.window), None)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, differentiable in q, k
    and v.

    q, k, v: (B, S, H, D), kv heads already repeated to H (GQA is the
    caller's).  Returns (B, S, H, D).  CPU tensors take the plain version;
    any other tensor goes to the CUDA kernel, which launches or raises.
    """
    return _SwaAttention.apply(q, k, v, window)
