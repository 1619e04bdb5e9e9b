"""Plain PyTorch versions of the fused cross-entropy kernel (port of
``repro.kernels.fused_ce.ref`` and of the arithmetic of
``repro.kernels.fused_ce.ce``).

``fused_ce_stats_ref`` computes what the Pallas ``fused_ce_stats`` computes,
with the whole (T, V) logits matrix materialised: CPU tensors take it, and
the tests and ``chip_smoke.py`` hold the CUDA kernel against it.
"""
from __future__ import annotations

from typing import Tuple

import torch

NEG_INF = -1e30


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


def cross_entropy_ref(hidden: torch.Tensor, head: torch.Tensor,
                      labels: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-logits cross entropy: (sum loss over labels >= 0, count)."""
    logits = hidden.float() @ head.float()
    lse = torch.logsumexp(logits, dim=-1)
    pick = torch.gather(logits, 1, labels.long().clamp(min=0)[:, None])[:, 0]
    mask = (labels >= 0).float()
    return ((lse - pick) * mask).sum(), mask.sum()
