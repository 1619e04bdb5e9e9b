"""ctypes binding of the hand-written Hopper kernel ``csrc/fused_ce_stats.cu``.

It replaces the Pallas TPU kernel ``repro.kernels.fused_ce.ce.fused_ce_stats``;
the source's header says how and what bounds it.  The library is built from
the repository's source at the first launch (``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_ce_stats.cu"
D_MULTIPLE = 32  # the kernel takes d a multiple of this
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _kernel():
    fn = _build.load(SOURCE).fused_ce_stats_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def tile(dtype: torch.dtype) -> Tuple[int, int]:
    """(tokens, vocab) of one block's tile for ``dtype``, as the library
    built from the source reports it: the source alone holds the tiles."""
    fn = _build.load(SOURCE).fused_ce_stats_tile
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(_DTYPE_CODES[dtype], 0), fn(_DTYPE_CODES[dtype], 1)


def vocab_splits(t: int, v: int, tile: Tuple[int, int], sms: int) -> int:
    """How many vocab ranges the kernel splits V into for a block tile of
    ``tile`` = (tokens, vocab): enough blocks for about two per SM, and
    never more ranges than vocab tiles."""
    bt, bv = tile
    row_tiles = -(-t // bt)
    return max(1, min(-(-v // bv), -(-2 * sms // row_tiles)))


def _tma_ready(hidden: torch.Tensor, head: torch.Tensor):
    """(hidden, head, sh, sd, sv) as the bf16 kernel's TMA reads them: in
    place where TMA can (16-byte aligned; hidden's row stride a multiple of
    8 elements; the head K-major, ``embed.T`` with strides (1, s), or
    MN-major, strides (s, 1), s a positive multiple of 8), else copied:
    hidden contiguous, the head into the K-major form.  Each copy adds one
    to ``fused_ce_stats.copies``.  A stride of an axis of length 1 is never
    stepped and is passed as 8."""
    t, d = hidden.shape
    v = head.shape[1]
    sh = hidden.stride(0) if t > 1 else 8
    if hidden.data_ptr() % 16 or sh % 8:
        hidden = torch.empty(t, d, dtype=hidden.dtype,
                             device=hidden.device).copy_(hidden)
        sh = d
        fused_ce_stats.copies += 1
    sd, sv = head.stride()
    sv = sv if v > 1 else 8
    in_place = head.data_ptr() % 16 == 0 and (
        (sd == 1 and sv > 0 and sv % 8 == 0)
        or (sv == 1 and sd > 0 and sd % 8 == 0))
    if not in_place:
        head = torch.empty(v, d, dtype=head.dtype,
                           device=head.device).copy_(head.T).T
        sd, sv = 1, d
        fused_ce_stats.copies += 1
    return hidden, head, sh, sd, sv


def fused_ce_stats(hidden: torch.Tensor, head: torch.Tensor,
                   labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current CUDA stream.

    hidden (T, d) with a contiguous last axis, head (d, V) with any strides
    (``embed.T`` is read in place), both float32 or both bfloat16, d a
    multiple of ``D_MULTIPLE``; labels (T,) integers.  Any T and V.  In
    bfloat16 the kernel reads hidden and head through TMA; what TMA cannot
    take in place (a head with neither stride 1, a stride that is not a
    multiple of 8 elements, an address that is not 16-byte aligned) is
    copied first (``_tma_ready``).  Returns new (lse (T, 1), pick (T, 1))
    f32, pick = -1e30 for a label outside [0, V).  Each launch adds one to
    ``fused_ce_stats.launches``.
    """
    if not (hidden.is_cuda and head.device == hidden.device
            and labels.device == hidden.device):
        raise ValueError("fused_ce_stats takes CUDA tensors on one device")
    if hidden.dim() != 2 or head.dim() != 2 or labels.dim() != 1:
        raise ValueError(f"hidden must be (T, d), head (d, V), labels (T,); "
                         f"got {tuple(hidden.shape)}, {tuple(head.shape)}, "
                         f"{tuple(labels.shape)}")
    t, d = hidden.shape
    v = head.shape[1]
    if head.shape[0] != d or labels.shape[0] != t:
        raise ValueError(f"shapes do not fit: hidden {tuple(hidden.shape)}, "
                         f"head {tuple(head.shape)}, labels "
                         f"{tuple(labels.shape)}")
    if hidden.dtype not in _DTYPE_CODES or head.dtype != hidden.dtype:
        raise ValueError(f"hidden and head must be both float32 or both "
                         f"bfloat16; got {hidden.dtype}, {head.dtype}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise ValueError(f"labels must be integers; got {labels.dtype}")
    if d % D_MULTIPLE or d == 0:
        raise ValueError(f"d = {d} is not a positive multiple of {D_MULTIPLE}")
    if v == 0 or v >= 2 ** 31 or t >= 2 ** 31:
        raise ValueError(f"T = {t} and V = {v} must be in [1, 2**31)")
    if hidden.stride(1) != 1:
        raise ValueError("the last axis of hidden must be contiguous")
    f32 = dict(dtype=torch.float32, device=hidden.device)
    lse = torch.empty(t, 1, **f32)
    pick = torch.empty(t, 1, **f32)
    if t == 0:
        return lse, pick
    sms = torch.cuda.get_device_properties(hidden.device).multi_processor_count
    nsplit = vocab_splits(t, v, tile(hidden.dtype), sms)
    part = torch.empty(3, nsplit, t, **f32)
    lab = labels.to(torch.int32).contiguous()
    if hidden.dtype == torch.bfloat16:
        hidden, head, sh, sd, sv = _tma_ready(hidden, head)
    else:
        (sh, sd, sv) = hidden.stride(0), *head.stride()
    with torch.cuda.device(hidden.device):
        err = _kernel()(
            _DTYPE_CODES[hidden.dtype], hidden.data_ptr(), sh,
            head.data_ptr(), sd, sv, lab.data_ptr(),
            lse.data_ptr(), pick.data_ptr(), part.data_ptr(), t, d, v, nsplit,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_ce_stats launch failed with CUDA error "
                           f"{err}")
    fused_ce_stats.launches += 1
    return lse, pick


fused_ce_stats.launches = 0
fused_ce_stats.copies = 0
