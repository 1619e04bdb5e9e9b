"""Plain PyTorch versions of the fused cross-entropy kernels (port of
``repro.kernels.fused_ce.ref`` and of the arithmetic of
``repro.kernels.fused_ce.ce``).

``fused_ce_stats_ref`` computes what the Pallas ``fused_ce_stats`` computes,
with the whole (T, V) logits matrix materialised, and ``fused_ce_bwd_ref``
its gradients, with the f32 logits a block of rows at a time
(``fused_ce_bwd_p_ref`` the coefficients in their place): CPU tensors
take them, and the tests and ``chip_smoke.py`` hold the CUDA kernels
against them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30
# rows of the logits ``fused_ce_bwd_ref`` recomputes at a time
BACKWARD_ROWS = 2048


def fused_ce_stats_ref(hidden: torch.Tensor, head: torch.Tensor,
                       labels: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """hidden (T, d) x head (d, V), labels (T,) -> (lse (T, 1), pick (T, 1)),
    both f32.

    Both operands are widened to f32 and their products summed in f32
    (``ce.py:38-41``).  ``lse = m + log(max(l, 1e-30))`` (``:62``); ``pick``
    is the label's logit, and -1e30 (its start value, ``:36``) for a label
    outside [0, V).  The kernel masks vocab positions >= V of its padded
    last tile to -1e30 (``:42-44``); here there is no padding to mask.
    """
    logits = hidden.float() @ head.float()
    m = logits.max(dim=-1, keepdim=True).values
    l = torch.exp(logits - m).sum(dim=-1, keepdim=True)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    lab = labels.long()[:, None]
    inside = (lab >= 0) & (lab < head.shape[1])
    picked = torch.gather(logits, 1, torch.where(inside, lab, 0))
    pick = torch.where(inside, picked, torch.full_like(picked, NEG_INF))
    return lse, pick


def fused_ce_bwd_p_ref(hidden: torch.Tensor, head: torch.Tensor,
                       labels: torch.Tensor, lse: torch.Tensor,
                       g_lse: Optional[torch.Tensor],
                       g_pick: Optional[torch.Tensor]) -> torch.Tensor:
    """The coefficients p (T, V) f32 that take the logits' place in the
    backward: with x = hidden head widened to f32 and the saved lse
    (T, 1), p = exp(x - lse) g_lse + onehot(label) g_pick, g_lse and
    g_pick (T,) or None for zeros, no term for a label outside [0, V)."""
    w = head.float()
    p = (hidden.float() @ w).sub_(lse.reshape(-1, 1)).exp_()
    if g_lse is None:
        p.zero_()
    else:
        p.mul_(g_lse.float()[:, None])
    if g_pick is not None:
        lab = labels.long()
        inside = (lab >= 0) & (lab < w.shape[1])
        p.scatter_add_(1, torch.where(inside, lab, 0)[:, None],
                       (g_pick.float() * inside)[:, None])
    return p


def fused_ce_bwd_ref(hidden: torch.Tensor, head: torch.Tensor,
                     labels: torch.Tensor, lse: torch.Tensor,
                     g_lse: Optional[torch.Tensor],
                     g_pick: Optional[torch.Tensor],
                     need_dh: bool = True, need_dw: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``fused_ce_stats_ref``'s (lse, pick) in hidden and
    head, given their coefficients g_lse and g_pick (T,), None for zeros:
    dh = p head^T and dW = hidden^T p with p of ``fused_ce_bwd_p_ref``,
    each summed in f32 and rounded once to hidden's and head's dtype.  The
    logits are recomputed ``BACKWARD_ROWS`` rows at a time, so a block's
    (rows, V) f32 logits bound the memory beside dW's f32 sum.  Returns
    new contiguous (dh (T, d), dW (d, V)); an output not needed
    (``need_dh``, ``need_dw`` False) is not computed and is returned
    empty, (0,)."""
    t, d = hidden.shape
    w = head.float()
    dh = hidden.new_empty((t, d) if need_dh else 0)
    dw = w.new_zeros((d, w.shape[1]) if need_dw else 0)
    for r0 in range(0, t, BACKWARD_ROWS):
        rows = slice(r0, r0 + BACKWARD_ROWS)
        h = hidden[rows].float()
        p = fused_ce_bwd_p_ref(h, w, labels[rows], lse[rows],
                               None if g_lse is None else g_lse[rows],
                               None if g_pick is None else g_pick[rows])
        if need_dh:
            dh[rows] = p @ w.T
        if need_dw:
            dw.addmm_(h.T, p)
    return dh, dw.to(head.dtype)


def cross_entropy_ref(hidden: torch.Tensor, head: torch.Tensor,
                      labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-logits cross entropy: (sum loss over labels >= 0, count)."""
    logits = hidden.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    pick = torch.gather(logits, 1, labels.long().clamp(min=0)[:, None])[:, 0]
    mask = (labels >= 0).float()
    return ((lse - pick) * mask).sum(), mask.sum()
