"""Plain PyTorch version of ``swa_flash``: naive masked softmax attention in
f32 with the whole score matrix materialised (port of
``repro.kernels.swa_attention.ref``)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      window: int = 0) -> torch.Tensor:
    """q, k, v: (..., S, D) with the same sequence length; causal plus an
    optional sliding window (query i sees keys in (i - window, i]).

    Returns q's dtype.
    """
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    sq, sk = q.shape[-2], k.shape[-2]
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = kp <= qp
    if window > 0:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.float()).to(q.dtype)
