"""ctypes binding of the hand-written Hopper kernel
``csrc/ssd_intra_chunk.cu``.

It replaces the Pallas TPU kernel
``repro.kernels.ssd_scan.ssd.ssd_intra_chunk``; the source's header says how
and what bounds it.  bf16 inputs (the serving paths) go to a kernel whose
blocks each own one chunk and a group of ``head_group`` heads and run all
three products on tensor cores (``mma.sync``); f32 inputs go to a kernel
that runs them as f32 FMAs, one block per (chunk, head).  The library is
built from the repository's source at the first launch
(``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_intra_chunk.cu"
HEAD_DIMS = (16, 32, 64, 128)
MAX_CHUNK = 128
MAX_STATE = 128
MAX_GROUP = 8        # most heads a bf16 block owns (GMAX in the source)
BLOCKS_PER_SM = 1    # bf16 blocks resident on one SM (its shared memory)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def head_group(bc: int, h: int, sms: int) -> int:
    """Heads G that one block of the bf16 kernel owns: the fewest that
    keep the grid, BC x ceil(H / G) blocks, within one wave of
    ``sms * BLOCKS_PER_SM``, and at most ``MAX_GROUP``.  A block computes
    C B^T once for its G heads, so fewer heads a block means more blocks
    recomputing it and more parallel work; a grid past one wave leaves a
    tail.  The last group holds H - (ceil(H / G) - 1) G heads."""
    groups = max(1, min(h, sms * BLOCKS_PER_SM // max(bc, 1)))
    return max(1, min(MAX_GROUP, -(-h // groups)))


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _kernel():
    fn = _build.load(SOURCE).ssd_intra_chunk_fwd
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   *(ctypes.c_void_p,) * 8,
                   *(ctypes.c_int,) * 5,
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_intra_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current CUDA stream.

    x: (BC, Q, H, P), b and c: (BC, Q, N), all float32 or all bfloat16;
    dt: (BC, Q, H) and a: (H,) float32.  CUDA tensors on one device with
    the last axis contiguous (any other strides); Q and N at most 128, P in
    ``HEAD_DIMS``, any BC and H.  Returns new contiguous f32 (y_intra (BC,
    Q, H, P), states (BC, H, P, N), cum (BC, Q, H)).  No operand is copied:
    the bf16 kernel reads rows that start on 16-byte boundaries (the views
    of the conv output on the serving paths) with 16-byte ``cp.async``, and
    any other rows element by element.  Each launch adds one to
    ``ssd_intra_chunk.launches``.
    """
    if not (x.is_cuda and all(t.device == x.device for t in (dt, a, b, c))):
        raise ValueError("ssd_intra_chunk takes CUDA tensors on one device")
    if x.dim() != 4:
        raise ValueError(f"x must be (BC, Q, H, P); got {tuple(x.shape)}")
    bc, q, h, p = x.shape
    n = b.shape[-1]
    if (dt.shape != (bc, q, h) or a.shape != (h,) or b.shape != (bc, q, n)
            or c.shape != b.shape):
        raise ValueError(
            f"shapes do not fit x {tuple(x.shape)}: dt {tuple(dt.shape)}, "
            f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}")
    if x.dtype not in _DTYPE_CODES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"x, b, c must be all float32 or all bfloat16; got "
                         f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"dt and a must be float32; got {dt.dtype}, {a.dtype}")
    if p not in HEAD_DIMS:
        raise ValueError(f"head dim {p} not in {HEAD_DIMS}")
    if not (1 <= q <= MAX_CHUNK and 1 <= n <= MAX_STATE):
        raise ValueError(f"chunk {q} and state dim {n} must be in "
                         f"[1, {MAX_CHUNK}] and [1, {MAX_STATE}]")
    if any(t.stride(-1) != 1 for t in (x, dt, a, b, c)):
        raise ValueError("the last axis of x, dt, a, b, c must be contiguous")
    g = (head_group(bc, h, _sms(x.device.index or 0))
         if x.dtype == torch.bfloat16 else 1)
    if bc * -(-h // g) >= 2 ** 31:
        raise ValueError(f"{bc} chunks x {h} heads exceed the grid")
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(bc, q, h, p, **f32)
    states = torch.empty(bc, h, p, n, **f32)
    cum = torch.empty(bc, q, h, **f32)
    if bc * h == 0:
        return y, states, cum
    strides = (ctypes.c_longlong * 9)(
        x.stride(0), x.stride(1), x.stride(2), dt.stride(0), dt.stride(1),
        b.stride(0), b.stride(1), c.stride(0), c.stride(1))
    with torch.cuda.device(x.device):
        err = _kernel()(
            _DTYPE_CODES[x.dtype], p, x.data_ptr(), dt.data_ptr(),
            a.data_ptr(), b.data_ptr(), c.data_ptr(), y.data_ptr(),
            states.data_ptr(), cum.data_ptr(), bc, q, h, n, g, strides,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_intra_chunk launch failed with CUDA error "
                           f"{err}")
    ssd_intra_chunk.launches += 1
    return y, states, cum


ssd_intra_chunk.launches = 0
