"""ctypes bindings of the hand-written Hopper kernels
``csrc/fused_ce_stats.cu`` and ``csrc/fused_ce_bwd.cu``.

The first replaces the Pallas TPU kernel
``repro.kernels.fused_ce.ce.fused_ce_stats``; the second, the statistics'
backward, replaces none (JAX differentiates ``chunked_cross_entropy``
through XLA).  Each source's header says how and what bounds it.  The
libraries are built from the repository's sources at the first launch
(``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "fused_ce_stats.cu"
BWD_SOURCE = SOURCE.with_name("fused_ce_bwd.cu")
D_MULTIPLE = 32  # the kernels take d a multiple of this
# The backward's scratch for p (two bf16 terms, 4 bytes a logit) holds at
# most as many bytes as this many rows of f32 logits over the whole
# vocabulary: the plain backward's block
SCRATCH_ROWS = 2048
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


def _tma_ready(hidden: torch.Tensor, head: torch.Tensor, counted):
    """(hidden, head, sh, sd, sv) as the bf16 kernels' TMA reads them: in
    place where TMA can (16-byte aligned; hidden's row stride a multiple of
    8 elements; the head K-major, ``embed.T`` with strides (1, s), or
    MN-major, strides (s, 1), s a positive multiple of 8), else copied:
    hidden contiguous, the head into the K-major form.  Each copy adds one
    to ``counted.copies`` (the wrapper that asked).  A stride of an axis of
    length 1 is never stepped and is passed as 8."""
    t, d = hidden.shape
    v = head.shape[1]
    sh = hidden.stride(0) if t > 1 else 8
    if hidden.data_ptr() % 16 or sh % 8:
        hidden = torch.empty(t, d, dtype=hidden.dtype,
                             device=hidden.device).copy_(hidden)
        sh = d
        counted.copies += 1
    sd, sv = head.stride()
    sv = sv if v > 1 else 8
    in_place = head.data_ptr() % 16 == 0 and (
        (sd == 1 and sv > 0 and sv % 8 == 0)
        or (sv == 1 and sd > 0 and sd % 8 == 0))
    if not in_place:
        head = torch.empty(v, d, dtype=head.dtype,
                           device=head.device).copy_(head.T).T
        sd, sv = 1, d
        counted.copies += 1
    return hidden, head, sh, sd, sv


def _check(name: str, hidden: torch.Tensor, head: torch.Tensor,
           labels: torch.Tensor, dtypes) -> None:
    """Raise ValueError on what the kernel ``name`` does not take: tensors
    off one CUDA device, shapes that do not fit (hidden (T, d), head
    (d, V), labels (T,)), hidden and head not both of one of ``dtypes``,
    labels that are not integers, d not a positive multiple of
    ``D_MULTIPLE``, T or V of 2**31 or more, or hidden's last axis not
    contiguous."""
    if not (hidden.is_cuda and head.device == hidden.device
            and labels.device == hidden.device):
        raise ValueError(f"{name} takes CUDA tensors on one device")
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
    if hidden.dtype not in dtypes or head.dtype != hidden.dtype:
        names = " or both ".join(str(dt).split(".")[1] for dt in dtypes)
        raise ValueError(f"hidden and head must be both {names}; got "
                         f"{hidden.dtype}, {head.dtype}")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise ValueError(f"labels must be integers; got {labels.dtype}")
    if d % D_MULTIPLE or d == 0:
        raise ValueError(f"d = {d} is not a positive multiple of {D_MULTIPLE}")
    if v == 0 or v >= 2 ** 31 or t >= 2 ** 31:
        raise ValueError(f"T = {t} and V = {v} must be in [1, 2**31)")
    if hidden.stride(1) != 1:
        raise ValueError("the last axis of hidden must be contiguous")


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
    _check("fused_ce_stats", hidden, head, labels, tuple(_DTYPE_CODES))
    t, d = hidden.shape
    v = head.shape[1]
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
        hidden, head, sh, sd, sv = _tma_ready(hidden, head, fused_ce_stats)
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


@functools.cache
def _bwd_kernel():
    fn = _build.load(BWD_SOURCE).fused_ce_bwd_p
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def vocab_block(t: int, v: int, tile_v: int) -> int:
    """Vocab columns of one block of the backward: blocks of equal width in
    whole vocab tiles of ``tile_v``, as few as keep p's scratch (4 T c
    bytes for c columns) within ``SCRATCH_ROWS`` rows of f32 logits over
    the whole vocabulary (4 SCRATCH_ROWS V bytes)."""
    widest = max(tile_v, SCRATCH_ROWS * v // t // tile_v * tile_v)
    blocks = -(-v // widest)
    return _round_up(-(-v // blocks), tile_v)


def bwd_launches(t: int, v: int) -> int:
    """The kernel launches of one ``fused_ce_bwd`` call at T = ``t`` and
    V = ``v``: one a vocabulary block, none for T = 0."""
    return -(-v // vocab_block(t, v, tile(torch.bfloat16)[1])) if t else 0


def _p_launcher(hidden: torch.Tensor, head: torch.Tensor,
                labels: torch.Tensor, lse: torch.Tensor,
                g_lse: Optional[torch.Tensor], g_pick: Optional[torch.Tensor]):
    """Check ``fused_ce_bwd``'s arguments, make them ready for the p
    kernel, and return ``launch(v0, ldc, p)``: the kernel on the current
    CUDA stream for the vocab columns [v0, v0 + ldc) into p, (T, 2, ldc)
    bf16 (hi, then lo, of each row; zeros past V), ldc a multiple of 8.
    Each launch adds one to ``fused_ce_bwd.launches``."""
    _check("fused_ce_bwd", hidden, head, labels, (torch.bfloat16,))
    t, d = hidden.shape
    v = head.shape[1]
    for name, x in (("lse", lse), ("g_lse", g_lse), ("g_pick", g_pick)):
        want = (t, 1) if name == "lse" else (t,)
        if x is not None and (x.shape != want or x.device != hidden.device
                              or not x.dtype.is_floating_point):
            raise ValueError(f"{name} must be a float {want} on "
                             f"{hidden.device}; got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    lab = labels.to(torch.int32).contiguous()
    lse, g_lse, g_pick = (None if x is None else x.float().contiguous()
                          for x in (lse, g_lse, g_pick))
    rows, w_in, sh, sd, sv = _tma_ready(hidden, head, fused_ce_bwd)
    sms = torch.cuda.get_device_properties(hidden.device).multi_processor_count

    def launch(v0: int, ldc: int, p: torch.Tensor) -> None:
        with torch.cuda.device(hidden.device):
            err = _bwd_kernel()(
                rows.data_ptr(), sh, w_in.data_ptr(), sd, sv, lab.data_ptr(),
                lse.data_ptr(), 0 if g_lse is None else g_lse.data_ptr(),
                0 if g_pick is None else g_pick.data_ptr(), p.data_ptr(), t,
                d, v, v0, ldc,
                vocab_splits(t, ldc, tile(torch.bfloat16), sms),
                torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_ce_bwd launch failed with CUDA error "
                               f"{err}")
        fused_ce_bwd.launches += 1

    return launch


def fused_ce_bwd_p(hidden: torch.Tensor, head: torch.Tensor,
                   labels: torch.Tensor, lse: torch.Tensor,
                   g_lse: Optional[torch.Tensor],
                   g_pick: Optional[torch.Tensor], v0: int, c: int
                   ) -> torch.Tensor:
    """The p ``fused_ce_bwd`` feeds its products for the vocab columns
    [v0, v0 + c), one launch: new (T, 2, ldc) bf16, hi then lo of each
    row, ldc = c rounded up to a multiple of 8, zeros past V.  Arguments
    as ``fused_ce_bwd`` takes them; for holding p's two terms against the
    plain f32 p."""
    p = torch.empty(hidden.shape[0], 2, _round_up(c, 8), dtype=hidden.dtype,
                    device=hidden.device)
    _p_launcher(hidden, head, labels, lse, g_lse, g_pick)(v0, p.shape[2], p)
    return p


def fused_ce_bwd(hidden: torch.Tensor, head: torch.Tensor,
                 labels: torch.Tensor, lse: torch.Tensor,
                 g_lse: Optional[torch.Tensor], g_pick: Optional[torch.Tensor],
                 need_dh: bool = True, need_dw: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients (dh (T, d), dW (d, V)) of the statistics
    ``fused_ce_stats`` gives, on the current CUDA stream:
    dh = p head^T and dW = hidden^T p with
    p = exp(x - lse) g_lse + [v == label] g_pick and x = hidden head.

    hidden, head, labels as ``fused_ce_stats`` takes them, in bfloat16
    only; lse (T, 1) f32, the forward's; g_lse and g_pick (T,), or None for
    zeros.  For each block of ``vocab_block`` columns the kernel writes p
    as bf16 hi + lo into a (T, 2, c) scratch (c rounded up to a multiple
    of 8), and bf16 products on the tensor cores (cuBLAS, ``torch.addmm``
    with f32 outputs) take hi and lo, each a strided view of the scratch,
    into one f32 sum each: dh += p_hi W^T + p_lo W^T over the block's
    columns, and dW's columns = h^T p_hi + h^T p_lo, finished in the block
    and rounded once to bf16; dh is carried in f32 and rounded once at the
    end (``fused_ce_bwd_p`` gives one block's p).  An output not needed
    (``need_dh``, ``need_dw`` False) is not computed and is returned
    empty, (0,).  What TMA cannot read in place is copied first,
    as ``fused_ce_stats`` does; each copy adds one to
    ``fused_ce_bwd.copies``.  Returns new contiguous bf16 (dh, dW).  Each
    launch, one a vocabulary block (``bwd_launches``), adds one to
    ``fused_ce_bwd.launches``.
    """
    launch = _p_launcher(hidden, head, labels, lse, g_lse, g_pick)
    t, d = hidden.shape
    v = head.shape[1]
    dh = torch.zeros(t, d, dtype=torch.float32, device=hidden.device) \
        if need_dh else hidden.new_empty(0)
    dw = head.new_empty((d, v) if need_dw else 0)
    if t == 0 or not (need_dh or need_dw):
        return dh.to(hidden.dtype), dw.zero_()
    block = vocab_block(t, v, tile(torch.bfloat16)[1])
    scratch = torch.empty(t * 2 * block, dtype=hidden.dtype,
                          device=hidden.device)
    for v0 in range(0, v, block):
        c = min(block, v - v0)
        ldc = _round_up(c, 8)
        p = scratch[:t * 2 * ldc]
        launch(v0, ldc, p)
        # p_hi and p_lo: (T, ldc) views with row stride 2 ldc, zeros past
        # V; ldc, a multiple of 8, keeps cuBLAS's operands aligned
        hi, lo = p.view(t, 2, ldc).unbind(1)
        if need_dh:
            w = head[:, v0:v0 + c].T
            if c < ldc:  # a ragged last block: the head's rows padded too
                w = torch.cat([w, w.new_zeros(ldc - c, d)])
            torch.addmm(dh, hi, w, out_dtype=torch.float32, out=dh)
            torch.addmm(dh, lo, w, out_dtype=torch.float32, out=dh)
        if need_dw:
            part = torch.mm(hidden.T, hi, out_dtype=torch.float32)
            torch.addmm(part, hidden.T, lo, out_dtype=torch.float32, out=part)
            dw[:, v0:v0 + c] = part[:, :c]
    return dh.to(hidden.dtype), dw


fused_ce_bwd.launches = 0
fused_ce_bwd.copies = 0
