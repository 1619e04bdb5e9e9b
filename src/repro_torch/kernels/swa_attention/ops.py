"""Public sliding-window attention op (port of
``repro.kernels.swa_attention.ops``), with its gradient and the
``repro_torch::swa_flash`` op (``kernels/_library.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels._library import KernelCost, kernel_op
from repro_torch.kernels.swa_attention.ref import (swa_attention_bwd_ref,
                                                   swa_attention_ref)
from repro_torch.kernels.swa_attention.swa import swa_flash


def causal_pairs(s: int, window: int) -> int:
    """(query, key) pairs the causal (windowed) mask keeps over S
    positions: query i sees min(i + 1, window) keys."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def swa_flash_cost(b: int, s: int, h: int, d: int, window: int,
                   elsize: int) -> KernelCost:
    """q, k, v read once and o written once (``elsize`` bytes an element);
    2 products (Q K^T, P V) of 2 flops per kept (query, key) pair and head
    dim."""
    return KernelCost(flops=4 * d * causal_pairs(s, window) * b * h,
                      bytes=4 * b * s * h * d * elsize)


def _plain(q, k, v, window):
    return swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2),
                             window=window).transpose(1, 2).contiguous()


def _kernel(q, k, v, window):
    return swa_flash(q, k, v, window=window)


swa_flash_op = kernel_op(
    "swa_flash", "(Tensor q, Tensor k, Tensor v, int window) -> Tensor",
    cpu=_plain, cuda=_kernel,
    fake=lambda q, k, v, window: q.new_empty(q.shape),
    cost=lambda q, k, v, window: swa_flash_cost(*q.shape, window,
                                                q.element_size()))


class _SwaAttention(torch.autograd.Function):
    """Forward: the ``repro_torch::swa_flash`` op (the kernel on CUDA
    tensors, the plain version on CPU tensors, the fake on fake tensors).
    Backward: plain torch (``swa_attention_bwd_ref``) on both devices.
    The kernel's output carries no graph of its own, so without this
    Function a card run would give q, k and v no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        ctx.save_for_backward(q, k, v)
        ctx.window = window
        return swa_flash_op(q, k, v, window)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*swa_attention_bwd_ref(q, k, v, do, ctx.window), None)


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """Causal (optionally sliding-window) attention, differentiable in q, k
    and v.

    q, k, v: (B, S, H, D), kv heads already repeated to H (GQA is the
    caller's).  Returns (B, S, H, D).  CPU tensors take the plain version,
    CUDA tensors the kernel, which launches or raises; any other device
    raises.
    """
    return _SwaAttention.apply(q, k, v, window)
