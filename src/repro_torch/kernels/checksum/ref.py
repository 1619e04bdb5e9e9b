"""Plain PyTorch version of the fingerprint kernel (port of
``repro.kernels.checksum.ref``): CPU tensors take it, and the tests and
``chip_smoke.py`` hold the CUDA kernel against it."""
from __future__ import annotations

import torch

from repro_torch.kernels.checksum.fingerprint import P1, P2, P3, P4

MASK = 0xFFFFFFFF
CHUNK = 1 << 22   # words per pass: bounds the int64 temporaries to 32 MB each


def fingerprint_u32_ref(words: torch.Tensor) -> torch.Tensor:
    """words: (N, 128) 4-byte words -> (4,) uint32 digest (the same math as
    the kernel, no tiling).

    The uint32 arithmetic runs in int64 masked to 32 bits: a product of two
    32-bit values wraps mod 2^64 in int64, which keeps its low 32 bits
    right, and each pass sums at most 2^22 terms under 2^32, far from
    int64's range.
    """
    flat = words.reshape(-1).view(torch.int32)
    lanes = torch.zeros(4, dtype=torch.int64, device=words.device)
    for start in range(0, flat.numel(), CHUNK):
        x = flat[start:start + CHUNK].to(torch.int64) & MASK
        pos = torch.arange(start, start + x.numel(), dtype=torch.int64,
                           device=words.device) & MASK
        w = (pos * P1 + P2) & MASK
        l0 = x * w
        l1 = (x ^ P3) * (w ^ P4)
        l2 = ((x * x + P4) & MASK) * w
        l3 = ((x + pos) & MASK) * ((pos * P3 + P1) & MASK)
        lanes += torch.stack([(t & MASK).sum() for t in (l0, l1, l2, l3)])
        lanes &= MASK
    return lanes.to(torch.uint32)
