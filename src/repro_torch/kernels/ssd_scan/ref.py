"""Plain PyTorch versions of the SSD scan (port of
``repro.kernels.ssd_scan.ref`` and of the Pallas kernel's body).

- ``ssd_intra_chunk_ref`` — what the Pallas ``ssd_intra_chunk`` computes
  (``repro/kernels/ssd_scan/ssd.py:24-54``), on its (BC, Q, ...) layout,
  with the whole (BC, Q, Q, H) decay tensor materialised.  CPU tensors take
  it in place of the CUDA kernel, and the kernel is held against it.
- ``ssd_chunked_ref`` — the chunked scan of ``repro.models.ssm.ssd_chunked``.
- ``ssd_sequential_ref`` — the O(L) recurrence, the ground-truth semantics.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def ssd_intra_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                        b: torch.Tensor, c: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (BC, Q, H, P), dt: (BC, Q, H), a: (H,), b/c: (BC, Q, N).

    Returns (y_intra (BC, Q, H, P), states (BC, H, P, N), cum (BC, Q, H)),
    all f32.
    """
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    q = x.shape[1]
    cum = torch.cumsum(dt * a, dim=1)                        # (BC, Q, H)
    cb = torch.einsum("ktn,ksn->kts", c, b)                  # (BC, Q, Q)
    seg = cum[:, :, None, :] - cum[:, None, :, :]            # cum_t - cum_s
    mask = torch.ones(q, q, dtype=torch.bool, device=x.device).tril()[:, :, None]
    # masked inside the exp (no overflow for s > t) and outside it
    decay = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    m = cb[..., None] * decay * dt[:, None, :, :]            # (BC, Q, Q, H)
    y = torch.einsum("ktsh,kshp->kthp", m, x)
    w = torch.exp(cum[:, -1:, :] - cum) * dt                 # (BC, Q, H)
    states = torch.einsum("ksh,ksn,kshp->khpn", w, b, x)
    return y, states, cum


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zeros after the sequence axis (axis 1)."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))


def ssd_chunked_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int,
                    initial_state: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (port of ``repro.models.ssm.ssd_chunked``).

    x (B, L, H, P), dt (B, L, H), a (H,), b/c (B, L, N) ->
    (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) f32).
    """
    bs, l, h, p = x.shape
    n = b.shape[-1]
    pad = (-l) % chunk
    if pad:
        x, dt, b, c = (_pad_seq(t, pad) for t in (x, dt, b, c))
    nc = x.shape[1] // chunk
    xq = x.reshape(bs, nc, chunk, h, p).float()
    dtq = dt.reshape(bs, nc, chunk, h)
    bq = b.reshape(bs, nc, chunk, n).float()
    cq = c.reshape(bs, nc, chunk, n).float()

    cum = torch.cumsum(dtq * a, dim=2)                       # (B, nc, Q, H)
    total = cum[:, :, -1, :]
    cb = torch.einsum("bqtn,bqsn->bqts", cq, bq)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()[:, :, None]
    decay = torch.exp(torch.where(mask, seg, -torch.inf))
    m = cb[..., None] * decay * dtq[:, :, None, :, :]
    y_intra = torch.einsum("bqtsh,bqshp->bqthp", m, xq)

    w = torch.exp(total[:, :, None, :] - cum) * dtq
    state_c = torch.einsum("bqsh,bqsn,bqshp->bqhpn", w, bq, xq)

    decay_chunk = torch.exp(total)                           # (B, nc, H)
    s = (torch.zeros(bs, h, p, n, device=x.device) if initial_state is None
         else initial_state.float())
    s_before = []
    for i in range(nc):
        s_before.append(s)
        s = s * decay_chunk[:, i, :, None, None] + state_c[:, i]
    y_inter = torch.einsum("bqtn,bqhpn,bqth->bqthp", cq,
                           torch.stack(s_before, 1), torch.exp(cum))
    y = (y_intra + y_inter).reshape(bs, nc * chunk, h, p)[:, :l]
    return y.to(x.dtype), s


def ssd_sequential_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor, c: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """O(L) sequential recurrence; returns (y (B, L, H, P), final) in f32."""
    bs, l, h, p = x.shape
    n = b.shape[-1]
    x, dt, a, b, c = (t.float() for t in (x, dt, a, b, c))
    state = torch.zeros(bs, h, p, n, device=x.device)
    ys = []
    for t in range(l):
        decay = torch.exp(dt[:, t] * a)                      # (B, H)
        upd = torch.einsum("bh,bn,bhp->bhpn", dt[:, t], b[:, t], x[:, t])
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", c[:, t], state))
    return torch.stack(ys, 1), state
