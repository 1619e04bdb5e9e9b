"""ctypes bindings of the hand-written Hopper kernels ``csrc/swa_flash.cu``
(the forward) and ``csrc/swa_flash_bwd.cu`` (its backward).

The forward replaces the Pallas TPU kernel
``repro.kernels.swa_attention.swa.swa_flash``; the backward replaces none
(JAX differentiates its jnp attention through XLA).  Each source's header
says how and what bounds it.  The libraries are built from the
repository's sources at the first launch (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "swa_flash.cu"
BWD_SOURCE = SOURCE.with_name("swa_flash_bwd.cu")
HEAD_DIMS = range(8, 129, 8)  # any multiple of 8 up to 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_head_dim(d: int) -> None:
    """Raise unless the kernel takes head dim ``d``: a multiple of 8 in
    [8, 128] (``HEAD_DIMS``)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not a multiple of 8 in [8, 128]")


def _tma_ready(t: torch.Tensor, wrapper) -> torch.Tensor:
    """``t`` if TMA can read it in place (a 16-byte aligned address, and
    each stride of a (B, S, H) axis longer than 1 a positive multiple of 8
    elements), else a contiguous copy; each copy adds one to
    ``wrapper.copies``."""
    if t.data_ptr() % 16 == 0 and all(
            st > 0 and st % 8 == 0
            for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
        return t
    wrapper.copies += 1
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


def _strides(t: torch.Tensor):
    """The (B, S, H) element strides, 8 for an axis of length 1 (never
    stepped; TMA wants a multiple of 16 bytes there too)."""
    return [st if n > 1 else 8 for st, n in zip(t.stride()[:3], t.shape[:3])]


@functools.cache
def _kernel():
    fn = _build.load(SOURCE).swa_flash_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernel():
    fn = _build.load(BWD_SOURCE).swa_flash_bwd
    fn.argtypes = [ctypes.c_int, *[ctypes.c_void_p] * 11, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(name: str, tensors, dtypes, window: int) -> None:
    """Raise unless ``tensors`` are CUDA tensors on one device, of one
    (B, S, H, D) shape and one dtype among ``dtypes``, D in
    ``HEAD_DIMS``, each with a contiguous last axis, and ``window >= 0``."""
    q = tensors[0]
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if q.dim() != 4 or any(t.shape != q.shape for t in tensors):
        raise ValueError(f"{name}'s tensors must share one (B, S, H, D) "
                         f"shape; got {[tuple(t.shape) for t in tensors]}")
    if q.dtype not in dtypes or any(t.dtype != q.dtype for t in tensors):
        raise ValueError(f"{name} takes {' or '.join(map(str, dtypes))} "
                         f"tensors of one dtype; got "
                         f"{[t.dtype for t in tensors]}")
    check_head_dim(q.shape[-1])
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError(f"the head_dim axis of {name}'s tensors must be "
                         f"contiguous")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")


def swa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int):
    """Launch the kernel on the current CUDA stream.

    q, k, v: (B, S, H, D) CUDA tensors of one shape and dtype (float32 or
    bfloat16), D a multiple of 8 in [8, 128] (``HEAD_DIMS``), last axis
    contiguous; any other strides.  In bfloat16 the kernel reads q, k and v
    through TMA, which takes a tensor in place only when its address is
    16-byte aligned and each stride of a (B, S, H) axis longer than 1 is a
    positive multiple of 8 elements; any other q, k or v is copied into a
    contiguous tensor first (``swa_flash.copies`` counts the copies; the
    model's q, k and v are contiguous and need none).  Returns a new
    contiguous (B, S, H, D) tensor of q's dtype and a new contiguous f32
    (B, H, S) tensor: each query row's log-sum-exp of its scaled, masked
    scores (natural log), which ``swa_flash_bwd`` takes.  Each launch adds
    one to ``swa_flash.launches``.
    """
    _check("swa_flash", (q, k, v), tuple(_DTYPE_CODES), window)
    b, s, h, d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t, swa_flash) for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in _strides(t)))
    with torch.cuda.device(q.device):
        err = _kernel()(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, s, h, strides,
            window, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"swa_flash launch failed with CUDA error {err}")
    swa_flash.launches += 1
    return out, lse


swa_flash.launches = 0
swa_flash.copies = 0

# the backward's query tile: its (lse, delta) scratch is padded to whole
# tiles of S
BWD_QUERY_TILE = 64


def swa_flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  o: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor, *,
                  window: int):
    """Launch the backward's three kernels on the current CUDA stream.

    q, k, v, o (``swa_flash``'s output) and dout (the gradient of o):
    bfloat16 (B, S, H, D) CUDA tensors of one shape, D in ``HEAD_DIMS``,
    last axis contiguous; any of them that TMA cannot read in place (see
    ``swa_flash``) is copied first (``swa_flash_bwd.copies``).  lse:
    ``swa_flash``'s f32 (B, H, S).  float32 is not taken: no configuration
    trains in f32 on the card, and the autograd function sends f32 to the
    plain backward.  Returns new contiguous bf16 (dq, dk, dv).  Scratch: an
    f32 (B, S, H, D) workspace for dq, summed with atomics, and B H S_pad
    (lse, delta) pairs.  Each call adds one to ``swa_flash_bwd.launches``.
    """
    _check("swa_flash_bwd", (q, k, v, o, dout), (torch.bfloat16,), window)
    b, s, h, d = q.shape
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse must be a contiguous float32 (B, H, S) = "
                         f"{(b, h, s)} on {q.device}; got {tuple(lse.shape)} "
                         f"{lse.dtype} on {lse.device}")
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
             for _ in range(3)]
    if q.numel() == 0:
        return tuple(grads)
    q, k, v, o, dout = (_tma_ready(t, swa_flash_bwd)
                        for t in (q, k, v, o, dout))
    s_pad = -(-s // BWD_QUERY_TILE) * BWD_QUERY_TILE
    stats = torch.empty(b * h * s_pad * 2, dtype=torch.float32,
                        device=q.device)
    dq_ws = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(
        *(st for t in (q, k, v, o, dout) for st in _strides(t)))
    with torch.cuda.device(q.device):
        err = _bwd_kernel()(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), stats.data_ptr(),
            dq_ws.data_ptr(), *(t.data_ptr() for t in grads), b, s, h,
            strides, window, 1.0 / math.sqrt(d),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"swa_flash_bwd launch failed with CUDA error "
                           f"{err}")
    swa_flash_bwd.launches += 1
    return tuple(grads)


swa_flash_bwd.launches = 0
swa_flash_bwd.copies = 0
