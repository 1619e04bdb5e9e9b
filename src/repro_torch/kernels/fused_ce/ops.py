"""Public fused-CE op (port of ``repro.kernels.fused_ce.ops``), with its
gradient.

The forward is the ``repro_torch::fused_ce_stats`` op
(``kernels/_library.py``): the kernel on CUDA tensors, its plain version on
CPU tensors, its fake on fake tensors.  The Pallas kernel has no backward
(JAX differentiates ``chunked_cross_entropy`` through XLA), so the backward
here is plain torch: it recomputes the logits chunk by chunk from the saved
``lse``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels._library import KernelCost, kernel_op
from repro_torch.kernels.fused_ce.ce import fused_ce_stats
from repro_torch.kernels.fused_ce.ref import fused_ce_stats_ref

# Rows of the logits the backward holds at once.  Beside hidden and its
# gradient it holds one (rows, V) f32 buffer (the logits, turned into p in
# place), the head in f32 and the f32 dW: at olmo-1b (V 50304, d 2048)
# 3 x 412 MB.
BACKWARD_ROWS = 2048


def fused_ce_stats_cost(t: int, d: int, v: int, elsize: int) -> KernelCost:
    """hidden (T, d), head (d, V) (``elsize`` bytes an element) and int32
    labels read once and lse, pick (f32) written once; 2 T d V flops."""
    return KernelCost(flops=2 * t * d * v,
                      bytes=elsize * (t * d + d * v) + 4 * t + 8 * t)


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
        hidden, head, labels, lse = ctx.saved_tensors
        need_h, need_w = ctx.needs_input_grad[:2]
        w = head.float()
        dh = torch.empty_like(hidden) if need_h else None
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) \
            if need_w else None
        for r0 in range(0, hidden.shape[0], BACKWARD_ROWS):
            rows = slice(r0, r0 + BACKWARD_ROWS)
            h = hidden[rows].float()
            lab = labels[rows].long()
            # p = (softmax - onehot(label)) * mask * g, in place of the logits
            p = torch.matmul(h, w).sub_(lse[rows]).exp_()
            keep = (lab >= 0).float()[:, None]
            p.scatter_add_(1, lab.clamp(min=0)[:, None], -keep)
            p.mul_(keep * g_loss)
            if need_h:
                dh[rows] = torch.matmul(p, w.T).to(hidden.dtype)
            if need_w:
                dw.addmm_(h.T, p)
        return dh, (dw.to(head.dtype) if need_w else None), None


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
        hidden, head, labels, lse = ctx.saved_tensors
        need_h, need_w = ctx.needs_input_grad[:2]
        w = head.float()
        dh = torch.empty_like(hidden) if need_h else None
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device) \
            if need_w else None
        for r0 in range(0, hidden.shape[0], BACKWARD_ROWS):
            rows = slice(r0, r0 + BACKWARD_ROWS)
            h = hidden[rows].float()
            # p = softmax * g_lse + onehot(label) * g_pick, in place of the
            # logits
            p = torch.matmul(h, w).sub_(lse[rows]).exp_()
            if g_lse is None:
                p.zero_()
            else:
                p.mul_(g_lse[rows, None])
            if g_pick is not None:
                lab = labels[rows].long()
                inside = (lab >= 0) & (lab < w.shape[1])
                p.scatter_add_(1, torch.where(inside, lab, 0)[:, None],
                               (g_pick[rows] * inside)[:, None])
            if need_h:
                dh[rows] = torch.matmul(p, w.T).to(hidden.dtype)
            if need_w:
                dw.addmm_(h.T, p)
        return dh, (dw.to(head.dtype) if need_w else None), None


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
