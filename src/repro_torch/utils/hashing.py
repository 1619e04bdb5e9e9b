"""Host-side content checksums (a copy of ``repro.utils.hashing``, which
is numpy only; the port keeps its own).

The paper's checksum-based dedup (§4.6, §5.2.1) fingerprints device buffers
by content.  On-device fingerprints use the CUDA kernel in
``repro_torch.kernels.checksum``; this module provides the host-side
checksums (used for checkpoint chunk addressing and in tests).  The same
input gives the same bytes out as the JAX package's functions.
"""
from __future__ import annotations

import hashlib
from typing import Any

import numpy as np


def buffer_checksum(arr: Any) -> str:
    """Stable content checksum of an array (dtype+shape+bytes)."""
    a = np.asarray(arr)
    h = hashlib.blake2b(digest_size=16)
    h.update(str(a.dtype).encode())
    h.update(str(a.shape).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def chunk_checksums(data: bytes, chunk_size: int = 1 << 20):
    """Content checksums of fixed-size chunks (CRIU page-dedup analogue)."""
    out = []
    for i in range(0, len(data), chunk_size):
        h = hashlib.blake2b(data[i:i + chunk_size], digest_size=16)
        out.append(h.hexdigest())
    return out
