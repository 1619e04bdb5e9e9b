"""ctypes binding of the hand-written Hopper kernel ``csrc/swa_flash.cu``.

It replaces the Pallas TPU kernel ``repro.kernels.swa_attention.swa.swa_flash``;
the source's header says how and what bounds it.  The library is built from
the repository's source at the first launch (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "swa_flash.cu"
HEAD_DIMS = range(8, 129, 8)  # any multiple of 8 up to 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_head_dim(d: int) -> None:
    """Raise unless the kernel takes head dim ``d``: a multiple of 8 in
    [8, 128] (``HEAD_DIMS``)."""
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not a multiple of 8 in [8, 128]")


def _tma_ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` if TMA can read it in place (a 16-byte aligned address, and
    each stride of a (B, S, H) axis longer than 1 a positive multiple of 8
    elements), else a contiguous copy; each copy adds one to
    ``swa_flash.copies``."""
    if t.data_ptr() % 16 == 0 and all(
            st > 0 and st % 8 == 0
            for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1):
        return t
    swa_flash.copies += 1
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
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def swa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              window: int) -> torch.Tensor:
    """Launch the kernel on the current CUDA stream.

    q, k, v: (B, S, H, D) CUDA tensors of one shape and dtype (float32 or
    bfloat16), D a multiple of 8 in [8, 128] (``HEAD_DIMS``), last axis
    contiguous; any other strides.  In bfloat16 the kernel reads q, k and v
    through TMA, which takes a tensor in place only when its address is
    16-byte aligned and each stride of a (B, S, H) axis longer than 1 is a
    positive multiple of 8 elements; any other q, k or v is copied into a
    contiguous tensor first (``swa_flash.copies`` counts the copies; the
    model's q, k and v are contiguous and need none).  Returns a new
    contiguous (B, S, H, D) tensor of q's dtype.  Each launch adds one to
    ``swa_flash.launches``.
    """
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("swa_flash takes CUDA tensors on one device")
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"swa_flash takes float32 or bfloat16 q, k, v of one "
                         f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
    b, s, h, d = q.shape
    check_head_dim(d)
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head_dim axis of q, k, v must be contiguous")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (q, k, v, out) for st in _strides(t)))
    with torch.cuda.device(q.device):
        err = _kernel()(
            _DTYPE_CODES[q.dtype], d, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, s, h, strides, window,
            1.0 / math.sqrt(d), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"swa_flash launch failed with CUDA error {err}")
    swa_flash.launches += 1
    return out


swa_flash.launches = 0
swa_flash.copies = 0
