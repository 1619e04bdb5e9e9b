"""Public SSD op: the intra-chunk kernel plus the inter-chunk recurrence
(port of ``repro.kernels.ssd_scan.ops``), with its gradient and the
``repro_torch::ssd_intra_chunk`` op (``kernels/_library.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels._library import KernelCost, kernel_op
from repro_torch.kernels.ssd_scan.ref import _pad_seq, ssd_intra_chunk_ref
from repro_torch.kernels.ssd_scan.ssd import ssd_intra_chunk


def ssd_intra_chunk_cost(bc: int, q: int, h: int, p: int, n: int,
                         elsize: int) -> KernelCost:
    """x, b, c (``elsize`` bytes an element), dt and a (f32) read once and
    y, states and cum (f32) written once; the products: C B^T once per
    chunk over the causal pairs, M x over the causal pairs per head,
    x^T (w B) in full per head."""
    read = elsize * bc * q * (h * p + 2 * n) + 4 * (bc * q * h + h)
    written = 4 * (bc * q * h * p + bc * h * p * n + bc * q * h)
    pairs = q * (q + 1) // 2
    return KernelCost(
        flops=2 * bc * (n * pairs + h * p * pairs + h * q * p * n),
        bytes=read + written)


def _plain(x, dt, a, b, c):
    return tuple(t.contiguous() for t in ssd_intra_chunk_ref(x, dt, a, b, c))


def _kernel(x, dt, a, b, c):
    return ssd_intra_chunk(x, dt, a, b, c)


def _fake(x, dt, a, b, c):
    bc, q, h, p = x.shape
    f32 = dict(dtype=torch.float32)
    return (x.new_empty((bc, q, h, p), **f32),
            x.new_empty((bc, h, p, b.shape[-1]), **f32),
            x.new_empty((bc, q, h), **f32))


ssd_intra_chunk_op = kernel_op(
    "ssd_intra_chunk",
    "(Tensor x, Tensor dt, Tensor a, Tensor b, Tensor c) "
    "-> (Tensor, Tensor, Tensor)",
    cpu=_plain, cuda=_kernel, fake=_fake,
    cost=lambda x, dt, a, b, c: ssd_intra_chunk_cost(
        *x.shape, b.shape[-1], x.element_size()))


class _SsdIntraChunk(torch.autograd.Function):
    """Forward: the ``repro_torch::ssd_intra_chunk`` op (the kernel on CUDA
    tensors, the plain version on CPU tensors, the fake on fake tensors).
    Backward: plain torch on both devices; it recomputes the plain
    version under autograd and takes the gradients of its three outputs
    (``cum`` too, which the inter-chunk part decays by).  The kernel's
    outputs carry no graph of their own, so without this Function a card
    run would give the SSM weights no gradient.  The JAX package has no
    Pallas backward either: its training forward differentiates the
    pure-jnp scan."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c):
        ctx.save_for_backward(x, dt, a, b, c)
        return ssd_intra_chunk_op(x, dt, a, b, c)

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
    contribution).  CPU tensors take the plain intra-chunk version, CUDA
    tensors the kernel, which launches or raises; any other device raises.
    The recurrence across chunks and the inter-chunk output stay plain
    torch under autograd, as JAX runs them outside Pallas.
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
