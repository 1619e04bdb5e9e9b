"""Simulated device memory with the paper's bidirectional allocator (§5.2.2).

Stable buffers (parameters, optimizer state — preserved across mini-batches)
are allocated from the HIGH end of the address space; transient buffers
(activations, workspace — variable-sized across replicas) from the LOW end.
Consequence (the paper's key invariant): as long as two replicas perform the
same *stable* allocation sequence, their stable buffers land at identical
addresses, no matter how the interleaved transient allocations diverge.

This is an executable model used by the splicing engine, the transparent
checkpointer and the property tests; data lives in numpy.

A copy of ``repro.core.buffers``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.utils.hashing import buffer_checksum


class OutOfMemory(Exception):
    pass


@dataclasses.dataclass
class Buffer:
    addr: int
    size: int
    stable: bool
    data: Optional[np.ndarray] = None     # None => allocated but not written
    freed: bool = False                   # lazily GC'd (paper §5.2.1)

    def checksum(self) -> str:
        assert self.data is not None, "checksum of unwritten buffer"
        return buffer_checksum(self.data)


class DeviceMemory:
    """Bidirectional bump allocator over a fixed-size address space."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.low = 0                      # next transient address (grows up)
        self.high = capacity              # next stable address (grows down)
        self.buffers: Dict[int, Buffer] = {}     # addr -> Buffer (live)
        self.lazy_freed: Dict[int, Buffer] = {}  # addr -> Buffer (GC-pending)

    # -- allocation ----------------------------------------------------------
    def alloc(self, size: int, stable: bool) -> Buffer:
        if self.low + size > self.high:
            self._gc(size)
        if self.low + size > self.high:
            raise OutOfMemory(f"alloc {size} (low={self.low} high={self.high})")
        if stable:
            self.high -= size
            addr = self.high
        else:
            addr = self.low
            self.low += size
        buf = Buffer(addr=addr, size=size, stable=stable)
        self.buffers[addr] = buf
        return buf

    def free(self, addr: int, lazy: bool = False) -> None:
        buf = self.buffers.pop(addr)
        buf.freed = True
        if lazy:
            # keep content resident so a later swap-in may be elided
            self.lazy_freed[addr] = buf
        self._maybe_shrink()

    def _maybe_shrink(self) -> None:
        """Bump pointers back when the frontier buffers are freed (simple
        bump-allocator reclamation; sufficient for the mini-batch allocation
        patterns this models)."""
        moved = True
        while moved:
            moved = False
            live_low = [a for a, b in self.buffers.items() if not b.stable]
            top = max((a + self.buffers[a].size for a in live_low), default=0)
            if top < self.low:
                self.low = top
                moved = True
            live_high = [a for a, b in self.buffers.items() if b.stable]
            bottom = min(live_high, default=self.capacity)
            if bottom > self.high:
                self.high = bottom
                moved = True

    def _gc(self, need: int) -> None:
        """Drop lazily-freed cached buffers to make room (paper: GC happens
        lazily on demand for fresh allocations)."""
        self.lazy_freed.clear()
        self._maybe_shrink()

    # -- content -------------------------------------------------------------
    def write(self, addr: int, data: np.ndarray) -> None:
        buf = self.buffers[addr]
        assert data.nbytes <= buf.size, (data.nbytes, buf.size)
        buf.data = np.array(data, copy=True)

    def read(self, addr: int) -> np.ndarray:
        buf = self.buffers[addr]
        assert buf.data is not None
        return buf.data

    def find_by_checksum(self, checksum: str) -> Optional[Buffer]:
        """Content lookup across live + lazily-freed buffers (paper §5.2.1:
        opportunistically cache versions on device)."""
        for pool in (self.buffers, self.lazy_freed):
            for buf in pool.values():
                if buf.data is not None and buf.checksum() == checksum:
                    return buf
        return None

    # -- introspection ---------------------------------------------------------
    def live_bytes(self) -> int:
        return sum(b.size for b in self.buffers.values())

    def stable_buffers(self) -> Dict[int, Buffer]:
        return {a: b for a, b in self.buffers.items() if b.stable}

    def transient_buffers(self) -> Dict[int, Buffer]:
        return {a: b for a, b in self.buffers.items() if not b.stable}
