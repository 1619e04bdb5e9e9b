"""Public fingerprint op (port of ``repro.kernels.checksum.ops``): the
content digest of any tensor, on the device that holds it, through the
``repro_torch::fingerprint_u32`` op (``kernels/_library.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._library import KernelCost, kernel_op
from repro_torch.kernels.checksum.fingerprint import (LANES, fingerprint_u32,
                                                       padded_words)
from repro_torch.kernels.checksum.ref import fingerprint_u32_ref
from repro_torch.utils import resolve_device

# integer instructions per word of the digest (csrc/fingerprint_u32.cu)
FP_OPS_PER_WORD = 10


def fingerprint_u32_cost(n_words: int) -> KernelCost:
    """The words read once and the 16-byte digest written once;
    ``FP_OPS_PER_WORD`` 32-bit integer instructions per word of the padded
    length the digest covers (``padded_words``), and no flops."""
    return KernelCost(flops=0, bytes=4 * n_words + 16,
                      int_ops=FP_OPS_PER_WORD * padded_words(n_words))


def _flat_words(arr: torch.Tensor) -> torch.Tensor:
    """The words of ``_as_words``, unpadded and 1-D: a view where the
    elements are 4 bytes and contiguous, else a new tensor."""
    a = arr.reshape(-1)
    if a.dtype in (torch.bfloat16, torch.float16):
        # zero-extend: a widened int16 carries the sign into the high half
        return (a.view(torch.int16).to(torch.int32) & 0xFFFF).view(torch.uint32)
    if a.element_size() in (4, 8):
        # an 8-byte element is two little-endian words, low word first
        return a.view(torch.uint32)
    if a.element_size() == 1:
        return a.view(torch.uint8).to(torch.int32).view(torch.uint32)
    return a.to(torch.float32).view(torch.uint32)


def _padded(words: torch.Tensor) -> torch.Tensor:
    """1-D 4-byte words as (N, 128) uint32, zero words appended to a
    multiple of 256 x 128."""
    words = words.view(torch.int32)
    pad = padded_words(words.numel()) - words.numel()
    words = torch.cat([words, words.new_zeros(pad)])
    return words.view(torch.uint32).reshape(-1, LANES)


def _as_words(arr: torch.Tensor) -> torch.Tensor:
    """Bit-exact view of any tensor as padded (N, 128) uint32 words, as
    JAX's ``_as_words``: 16-bit floats zero-extended, 4- and 8-byte
    elements as their words, 1-byte elements widened, anything else as
    float32 values; zero words to a multiple of 256 x 128."""
    return _padded(_flat_words(arr))


def _kernel(words):
    return fingerprint_u32(words)


fingerprint_u32_op = kernel_op(
    "fingerprint_u32", "(Tensor words) -> Tensor",
    cpu=lambda words: fingerprint_u32_ref(_padded(words)), cuda=_kernel,
    fake=lambda words: words.new_empty((4,), dtype=torch.uint32),
    cost=lambda words: fingerprint_u32_cost(words.numel()))


def fingerprint(arr: torch.Tensor) -> torch.Tensor:
    """128-bit content digest of a tensor, computed on its device: (4,)
    uint32.

    Equal contents (same dtype and shape) always give equal digests;
    distinct contents collide with probability ~2^-128 under the
    position-weighted modular-sum family.  The op
    ``repro_torch::fingerprint_u32`` takes the words: CPU tensors the plain
    version, CUDA tensors the kernel, which launches or raises; any other
    device raises.  A contiguous tensor of 4-byte elements goes to the
    kernel as it is, with no padded copy.
    """
    return fingerprint_u32_op(_flat_words(arr))


def _to_tensor(arr) -> torch.Tensor:
    """A host array as a tensor, narrowed as ``jnp.asarray`` narrows with
    64-bit types off: 64-bit ints to 32-bit, float64 to float32."""
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: the same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    narrow = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
              np.dtype(np.float64): np.float32}
    if a.dtype in narrow:
        a = a.astype(narrow[a.dtype])
    return torch.from_numpy(np.array(a))  # a writable copy


def digest_hex(arr, device=None) -> str:
    """Hex string of the digest.  A tensor is digested where it lies; any
    other array (numpy, a list) is narrowed as ``jnp.asarray`` narrows it
    and digested on ``device`` (default ``cuda``)."""
    if not isinstance(arr, torch.Tensor):
        arr = _to_tensor(arr).to(resolve_device(device or "cuda"))
    d = fingerprint(arr).cpu().numpy()
    return "".join(f"{int(x):08x}" for x in d)
