"""Public SSD op: the intra-chunk kernel plus the inter-chunk recurrence
(port of ``repro.kernels.ssd_scan.ops``), with its gradient."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan.ref import _pad_seq, ssd_intra_chunk_ref
from repro_torch.kernels.ssd_scan.ssd import ssd_intra_chunk


class _SsdIntraChunk(torch.autograd.Function):
    """Forward: ``ssd_intra_chunk`` on CUDA tensors, the plain version on
    CPU tensors.  Backward: plain torch on both; it recomputes the plain
    version under autograd and takes the gradients of its three outputs
    (``cum`` too, which the inter-chunk part decays by).  The kernel's
    outputs carry no graph of their own, so without this Function a card
    run would give the SSM weights no gradient.  The JAX package has no
    Pallas backward either: its training forward differentiates the
    pure-jnp scan."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c):
        ctx.save_for_backward(x, dt, a, b, c)
        if x.device.type == "cpu":
            return ssd_intra_chunk_ref(x, dt, a, b, c)
        return ssd_intra_chunk(x, dt, a, b, c)

    @staticmethod
    def backward(ctx, dy, dstates, dcum):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
            pairs = [(out, g) for out, g in zip(ssd_intra_chunk_ref(*ins),
                                                (dy, dstates, dcum))
                     if out.requires_grad]   # cum does not depend on x
            grads = iter(torch.autograd.grad(
                [out for out, _ in pairs], [t for t in ins if t.requires_grad],
                [g for _, g in pairs], allow_unused=True))
        return tuple(next(grads) if n else None for n in need)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan, the contract of ``ssd_chunked_pallas``,
    differentiable in x, dt, a, b, c and ``initial_state``.

    x (B, L, H, P), dt (B, L, H), a (H,), b/c (B, L, N) ->
    (y (B, L, H, P) in x's dtype, final_state (B, H, P, N) f32).  L is
    padded to a multiple of ``chunk`` with zeros (dt = 0: no decay and no
    contribution).  CPU tensors take the plain intra-chunk version; any
    other tensor goes to the CUDA kernel, which launches or raises.  The
    recurrence across chunks and the inter-chunk output stay plain torch
    under autograd, as JAX runs them outside Pallas.
    """
    bs, l, h, p = x.shape
    n = b.shape[-1]
    pad = (-l) % chunk
    if pad:
        x, dt, b, c = (_pad_seq(t, pad) for t in (x, dt, b, c))
    nc = x.shape[1] // chunk
    y_intra, states, cum = _SsdIntraChunk.apply(
        x.reshape(bs * nc, chunk, h, p), dt.reshape(bs * nc, chunk, h),
        a.float(), b.reshape(bs * nc, chunk, n), c.reshape(bs * nc, chunk, n))
    y_intra = y_intra.view(bs, nc, chunk, h, p)
    states = states.view(bs, nc, h, p, n)
    cum = cum.view(bs, nc, chunk, h)

    decay_chunk = torch.exp(cum[:, :, -1, :])                # (B, nc, H)
    s = (torch.zeros(bs, h, p, n, device=x.device) if initial_state is None
         else initial_state.float())
    s_before = []
    for i in range(nc):
        s_before.append(s)
        s = s * decay_chunk[:, i, :, None, None] + states[:, i]
    # y_inter[t] = C_t . (exp(cum_t) S_in): one batched product, then the
    # decay (a three-operand torch.einsum would plan its contraction order
    # on the host at every call)
    y_inter = torch.einsum("bqtn,bqhpn->bqthp",
                           c.reshape(bs, nc, chunk, n).float(),
                           torch.stack(s_before, 1)) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bs, nc * chunk, h, p)[:, :l]
    return y.to(x.dtype), s
