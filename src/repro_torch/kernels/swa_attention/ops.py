"""Public sliding-window attention op (port of
``repro.kernels.swa_attention.ops``), with its gradient and the
``repro_torch::swa_flash`` and ``repro_torch::swa_flash_bwd`` ops
(``kernels/_library.py``)."""
from __future__ import annotations

import torch

from repro_torch.kernels._library import KernelCost, kernel_op
from repro_torch.kernels.swa_attention.ref import (swa_attention_bwd_ref,
                                                   swa_attention_lse_ref)
from repro_torch.kernels.swa_attention.swa import swa_flash, swa_flash_bwd


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
    dim.  The f32 log-sum-exp written beside o (4 B H S bytes, 1 / (2 D)
    of o's bytes in bf16) is left out."""
    return KernelCost(flops=4 * d * causal_pairs(s, window) * b * h,
                      bytes=4 * b * s * h * d * elsize)


def swa_flash_bwd_cost(b: int, s: int, h: int, d: int, window: int,
                       elsize: int) -> KernelCost:
    """5 products of 2 flops per kept (query, key) pair and head dim: the
    scores Q K^T again, dP = dO V^T, dV = P^T dO, dK = dS^T Q and
    dQ = dS K; q, k, v, o, dO read once and dq, dk, dv written once
    (``elsize`` bytes an element), and the f32 log-sum-exp read once."""
    return KernelCost(flops=10 * d * causal_pairs(s, window) * b * h,
                      bytes=8 * b * s * h * d * elsize + 4 * b * h * s)


def _plain(q, k, v, window):
    o, lse = swa_attention_lse_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=window)
    return o.transpose(1, 2).contiguous(), lse


def _kernel(q, k, v, window):
    return swa_flash(q, k, v, window=window)


swa_flash_op = kernel_op(
    "swa_flash",
    "(Tensor q, Tensor k, Tensor v, int window) -> (Tensor, Tensor)",
    cpu=_plain, cuda=_kernel,
    fake=lambda q, k, v, window: (
        q.new_empty(q.shape),
        q.new_empty((q.shape[0], q.shape[2], q.shape[1]),
                    dtype=torch.float32)),
    cost=lambda q, k, v, window: swa_flash_cost(*q.shape, window,
                                                q.element_size()))


def _plain_bwd(q, k, v, o, dout, lse, window):
    return swa_attention_bwd_ref(q, k, v, dout, window)


def _bwd_kernel(q, k, v, o, dout, lse, window):
    return swa_flash_bwd(q, k, v, o, dout, lse, window=window)


swa_flash_bwd_op = kernel_op(
    "swa_flash_bwd",
    "(Tensor q, Tensor k, Tensor v, Tensor o, Tensor dout, Tensor lse, "
    "int window) -> (Tensor, Tensor, Tensor)",
    cpu=_plain_bwd, cuda=_bwd_kernel,
    fake=lambda q, k, v, o, dout, lse, window: tuple(
        q.new_empty(q.shape) for _ in range(3)),
    cost=lambda q, k, v, o, dout, lse, window: swa_flash_bwd_cost(
        *q.shape, window, q.element_size()))


class _SwaAttention(torch.autograd.Function):
    """Forward: the ``repro_torch::swa_flash`` op (the kernel on CUDA
    tensors, the plain version on CPU tensors, the fake on fake tensors),
    which also gives each query row's log-sum-exp.  Backward: the
    ``repro_torch::swa_flash_bwd`` op, which recomputes P from q, k and
    that log-sum-exp (the kernel on bf16 CUDA tensors, the plain backward
    ``swa_attention_bwd_ref`` on CPU tensors).  float32 takes the plain
    backward on every device: no configuration trains in f32 on the card,
    and the card's f32 tests hold the forward at 1e-5, where the bf16
    kernel's hi + lo products would not.  The kernel's output carries no
    graph of its own, so without this Function a card run would give q, k
    and v no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        o, lse = swa_flash_op(q, k, v, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.dtype == torch.float32:
            return (*swa_attention_bwd_ref(q, k, v, do, ctx.window), None)
        return (*swa_flash_bwd_op(q, k, v, o, do, lse, ctx.window), None)


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
