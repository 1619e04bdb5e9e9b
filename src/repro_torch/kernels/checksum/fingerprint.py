"""ctypes binding of the hand-written Hopper kernel ``csrc/fingerprint_u32.cu``.

It replaces the Pallas TPU kernel
``repro.kernels.checksum.fingerprint.fingerprint_u32``: a 128-bit content
digest, four uint32 lanes of position-weighted sums with wraparound (§4.6:
every live device buffer is fingerprinted on the device, so only the digest
crosses to the host).  The source's header says how and what bounds it.
The library is built from the repository's source at the first launch
(``kernels/_build.py``).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build

SOURCE = Path(__file__).resolve().parent / "csrc" / "fingerprint_u32.cu"

ROWS = 256                    # the Pallas kernel's block: 256 x 128 words
LANES = 128
BLOCK_WORDS = ROWS * LANES    # the digest covers a multiple of this

# The JAX module's constants, as Python ints
P1 = 2654435761               # Knuth multiplicative
P2 = 0x9E3779B9               # golden ratio
P3 = 0x85EBCA6B               # murmur3 c1
P4 = 0xC2B2AE35               # murmur3 c2


def padded_words(n: int) -> int:
    """The length the digest covers: ``n`` words padded with zero words to
    a multiple of ``BLOCK_WORDS``."""
    return -(-n // BLOCK_WORDS) * BLOCK_WORDS


@functools.cache
def _kernel():
    fn = _build.load(SOURCE).fingerprint_u32_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fingerprint_u32(words: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current CUDA stream.

    words: a contiguous CUDA tensor of 4-byte elements, read as uint32
    words: JAX's (N, 128) uint32 with N a multiple of ``ROWS``, or any
    length, which the digest covers as if padded with zero words to a
    multiple of ``BLOCK_WORDS`` (the buffer is read in place, not padded).
    Returns a new (4,) uint32 digest on the same device.  Each launch adds
    one to ``fingerprint_u32.launches``; an empty buffer launches nothing
    and has the zero digest.
    """
    if not words.is_cuda:
        raise ValueError("fingerprint_u32 takes a CUDA tensor")
    if words.element_size() != 4:
        raise ValueError(f"fingerprint_u32 takes 4-byte words; got "
                         f"{words.dtype}")
    if not words.is_contiguous():
        raise ValueError("fingerprint_u32 takes a contiguous tensor")
    n = words.numel()
    out = torch.empty(4, dtype=torch.int32, device=words.device)
    if n == 0:
        return out.zero_().view(torch.uint32)
    with torch.cuda.device(words.device):
        err = _kernel()(words.data_ptr(), n, padded_words(n), out.data_ptr(),
                        _sms(words.device),
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fingerprint_u32 launch failed with CUDA error "
                           f"{err}")
    fingerprint_u32.launches += 1
    return out.view(torch.uint32)


fingerprint_u32.launches = 0
