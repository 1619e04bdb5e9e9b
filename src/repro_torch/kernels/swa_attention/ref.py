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


def swa_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          do: torch.Tensor, window: int = 0):
    """Gradient of causal (sliding-window) attention: (dq, dk, dv).

    q, k, v, do: (B, S, H, D), as ``swa_flash`` takes them.  The softmax is
    recomputed from q and k in f32, one batch row at a time, so the (H, S, S)
    f32 scores of one row bound the memory (1.07 GB at H 16, S 4096; the
    backward holds three such buffers at its peak).  Returns the inputs'
    dtype.  The JAX ``swa_flash`` has no backward kernel either: JAX
    differentiates its jnp attention through XLA.
    """
    b, s, _, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(s, device=q.device)[None, :]
    hidden = kp > qp
    if window > 0:
        hidden |= kp <= qp - window
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    for i in range(b):
        qi, ki, vi, doi = (t[i].transpose(0, 1).float() for t in (q, k, v, do))
        p = torch.softmax(torch.matmul(qi, ki.transpose(-1, -2)).mul_(scale)
                          .masked_fill_(hidden, NEG_INF), dim=-1)
        dv[i] = torch.matmul(p.transpose(-1, -2), doi).transpose(0, 1)
        dp = torch.matmul(doi, vi.transpose(-1, -2))
        # ds = p * (dp - rowsum(p * dp)), in the place of dp
        ds = dp.sub_((dp * p).sum(dim=-1, keepdim=True)).mul_(p)
        del p
        dq[i] = torch.matmul(ds, ki).mul_(scale).transpose(0, 1)
        dk[i] = torch.matmul(ds.transpose(-1, -2), qi).mul_(scale).transpose(0, 1)
    return dq, dk, dv
