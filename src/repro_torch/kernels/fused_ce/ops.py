"""Public fused-CE op (port of ``repro.kernels.fused_ce.ops``), with its
gradient.

The forward is the ``repro_torch::fused_ce_stats`` op and the backward the
``repro_torch::fused_ce_bwd`` op (``kernels/_library.py``): each the kernel
on bf16 CUDA tensors, its plain version on CPU tensors, its fake on fake
tensors.  The Pallas kernel has no backward (JAX differentiates
``chunked_cross_entropy`` through XLA); ``fused_ce_bwd`` recomputes the
logits from the saved ``lse``, and both autograd functions call it.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._library import KernelCost, kernel_op
from repro_torch.kernels.fused_ce.ce import fused_ce_bwd, fused_ce_stats
from repro_torch.kernels.fused_ce.ref import (fused_ce_bwd_ref,
                                              fused_ce_stats_ref)


def fused_ce_stats_cost(t: int, d: int, v: int, elsize: int) -> KernelCost:
    """hidden (T, d), head (d, V) (``elsize`` bytes an element) and int32
    labels read once and lse, pick (f32) written once; 2 T d V flops."""
    return KernelCost(flops=2 * t * d * v,
                      bytes=elsize * (t * d + d * v) + 4 * t + 8 * t)


def fused_ce_bwd_cost(t: int, d: int, v: int, elsize: int,
                      need_dh: bool = True, need_dw: bool = True
                      ) -> KernelCost:
    """The least work of the backward: products of 2 T d V flops, the
    logits again and each of dh and dW needed; hidden and head
    (``elsize`` bytes an element) read once, int32 labels and the f32
    lse, g_lse and g_pick read once, dh and dW written once if needed."""
    return KernelCost(flops=2 * t * d * v * (1 + need_dh + need_dw),
                      bytes=elsize * (t * d * (1 + need_dh)
                                      + d * v * (1 + need_dw)) + 16 * t)


def _kernel(hidden, head, labels):
    return fused_ce_stats(hidden, head, labels)


def _fake(hidden, head, labels):
    t = hidden.shape[0]
    return (hidden.new_empty((t, 1), dtype=torch.float32),
            hidden.new_empty((t, 1), dtype=torch.float32))


fused_ce_stats_op = kernel_op(
    "fused_ce_stats",
    "(Tensor hidden, Tensor head, Tensor labels) -> (Tensor, Tensor)",
    cpu=fused_ce_stats_ref, cuda=_kernel, fake=_fake,
    cost=lambda hidden, head, labels: fused_ce_stats_cost(
        *hidden.shape, head.shape[1], hidden.element_size()))


def _bwd_kernel(hidden, head, labels, lse, g_lse, g_pick, need_dh=True,
                need_dw=True):
    # float32 keeps the plain backward on the card: no configuration trains
    # in f32 there, and the card's f32 tests hold the gradients at 1e-5,
    # where p's hi + lo would not
    bwd = fused_ce_bwd_ref if hidden.dtype == torch.float32 else fused_ce_bwd
    return bwd(hidden, head, labels, lse, g_lse, g_pick, need_dh, need_dw)


def _bwd_fake(hidden, head, labels, lse, g_lse, g_pick, need_dh=True,
              need_dw=True):
    return (hidden.new_empty(hidden.shape if need_dh else 0),
            head.new_empty(head.shape if need_dw else 0))


def _bwd_cost(hidden, head, labels, lse, g_lse, g_pick, need_dh=True,
              need_dw=True):
    return fused_ce_bwd_cost(*hidden.shape, head.shape[1],
                             hidden.element_size(), need_dh, need_dw)


fused_ce_bwd_op = kernel_op(
    "fused_ce_bwd",
    "(Tensor hidden, Tensor head, Tensor labels, Tensor lse, Tensor? g_lse, "
    "Tensor? g_pick, bool need_dh=True, bool need_dw=True) -> "
    "(Tensor, Tensor)",
    cpu=fused_ce_bwd_ref, cuda=_bwd_kernel, fake=_bwd_fake,
    cost=_bwd_cost)


def _grads(ctx, g_lse, g_pick):
    """(dh, dW, None) of the op, each None where autograd needs none."""
    hidden, head, labels, lse = ctx.saved_tensors
    need_h, need_w = ctx.needs_input_grad[:2]
    dh, dw = fused_ce_bwd_op(hidden, head, labels, lse, g_lse, g_pick,
                             need_h, need_w)
    return (dh if need_h else None), (dw if need_w else None), None


class _FusedCrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, head, labels):
        lse, pick = fused_ce_stats_op(hidden, head, labels.clamp(min=0))
        mask = (labels >= 0).float()
        loss = ((lse[:, 0] - pick[:, 0]) * mask).sum()
        ctx.save_for_backward(hidden, head, labels, lse)
        count = mask.sum()
        ctx.mark_non_differentiable(count)
        return loss, count

    @staticmethod
    def backward(ctx, g_loss, _g_count):
        # p = (softmax - onehot(label)) * mask * g
        g = g_loss * (ctx.saved_tensors[2] >= 0).float()
        return _grads(ctx, g, -g)


class _FusedCEStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, head, labels):
        lse, pick = fused_ce_stats_op(hidden, head, labels)
        inside = (labels >= 0) & (labels < head.shape[1])
        pick = torch.where(inside[:, None], pick, 0.0)
        ctx.save_for_backward(hidden, head, labels, lse)
        ctx.set_materialize_grads(False)
        return lse[:, 0], pick[:, 0]

    @staticmethod
    def backward(ctx, g_lse, g_pick):
        # p = softmax * g_lse + onehot(label) * g_pick
        return _grads(ctx, g_lse, g_pick)


def fused_ce_shard_stats(hidden: torch.Tensor, head: torch.Tensor,
                         labels: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lse (T,), pick (T,)) of each row over the vocabulary ``head``
    holds, differentiable in hidden and head: the statistics of one shard
    of a vocabulary-parallel CE.  pick is the label's logit, 0 for a label
    outside [0, V) (held by another shard, or ignored); the caller
    combines the shards' lse by a logsumexp and their picks by a sum.
    Shapes as ``fused_cross_entropy``'s; the forward is the kernel on CUDA
    tensors, its plain version on CPU tensors; any other device raises."""
    return _FusedCEStats.apply(hidden.contiguous(), head, labels)


def fused_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                        labels: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-level CE without materialising the (T, V) logits.

    hidden: (T, d); head: (d, V) (any strides); labels: (T,) int, < 0 =
    ignore.  Returns (sum loss, token count), the contract of
    ``models.model.chunked_cross_entropy`` on flattened inputs; the sum loss
    is differentiable in hidden and head.  The JAX wrapper pads T to the
    Pallas kernel's 128-token tile; the CUDA kernel masks a ragged T
    itself, so nothing is padded here.
    """
    return _FusedCrossEntropy.apply(hidden.contiguous(), head, labels)
