"""Replica splicing: semantics-aware time-slicing of DP ranks on one device (§5).

This is the buffer-level executable model of the paper's mechanism.  One
physical device hosts several logical ranks of the same data-parallel
group.  Each rank has its OWN device address space (its view through the
device proxy, bookkept by a per-rank bidirectional allocator from
``core/buffers.py``); the address spaces overlay one physical memory, and
only the resident rank's content is live.  Context switches happen at the
gradient sync point; the engine implements:

- §5.1 semantics-aware time-slicing: one rank executes at a time; gradients
  are accumulated locally in a proxy scratch buffer and a single cross-
  device allreduce is issued by the last resident rank ("NCCL sees one rank
  per GPU").
- §5.2.1 checksum-based dynamic dedup: conditional swap-out (skip if host
  already holds the content) and conditional swap-in (skip if the device
  already holds it at that address; D2D move if elsewhere).
- §5.2.2 consistent allocations: per-rank bidirectional allocators give
  stable buffers (P, O) identical addresses across ranks whenever their
  stable allocation sequences match — even when variable-sized transient
  allocations diverge.  With identical addresses, a squashed rank simply
  *sees* the root rank's update in physical memory.
- §5.2.3 squashing: parameter/optimizer-update ops execute only on the root
  rank and are omitted on the others — protected by conservative validation
  (``core/validation.py``).

The JAX hot path plays this role inside the compiled step
(``core/elastic.py``); this model is what the checkpoint/migration layers
and the paper-reproduction benchmarks (Fig 4 structure) run against.

A copy of ``repro.core.splicing``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.buffers import DeviceMemory
from repro_torch.utils.hashing import buffer_checksum


@dataclasses.dataclass
class SpliceMetrics:
    swapout_bytes: int = 0
    swapin_bytes: int = 0
    elided_swapouts: int = 0
    elided_swapins: int = 0
    d2d_moves: int = 0
    squashed_ops: int = 0
    executed_update_ops: int = 0
    context_switches: int = 0
    allreduces_issued: int = 0

    def add(self, other: "SpliceMetrics") -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))


class HostStore:
    """Host memory as a content-addressed cache (checksum -> bytes)."""

    def __init__(self):
        self.by_checksum: Dict[str, np.ndarray] = {}

    def has(self, cs: str) -> bool:
        return cs in self.by_checksum

    def put(self, data: np.ndarray) -> str:
        cs = buffer_checksum(data)
        if cs not in self.by_checksum:
            self.by_checksum[cs] = np.array(data, copy=True)
        return cs

    def get(self, cs: str) -> np.ndarray:
        return self.by_checksum[cs]


@dataclasses.dataclass
class RankView:
    """One logical rank's device view: its allocator + name->addr map and the
    expected (host-side) content checksums of its non-resident buffers."""
    rank: int
    mem: DeviceMemory
    buffers: Dict[str, Tuple[int, bool]] = dataclasses.field(default_factory=dict)
    expected: Dict[str, str] = dataclasses.field(default_factory=dict)


class SplicedDevice:
    """One physical device time-slicing several logical DP ranks."""

    def __init__(self, capacity: int, ranks: List[int], device_id: int = 0):
        self.capacity = capacity
        self.device_id = device_id
        self.views = {r: RankView(r, DeviceMemory(capacity)) for r in ranks}
        # physical device content: addr -> ndarray (the resident overlay)
        self.physical: Dict[int, np.ndarray] = {}
        self.host = HostStore()
        self.active_rank: Optional[int] = ranks[0]
        self.metrics = SpliceMetrics()

    # ------------------------------------------------------------------ alloc
    def alloc(self, rank: int, name: str, nbytes: int, stable: bool) -> int:
        view = self.views[rank]
        buf = view.mem.alloc(nbytes, stable)
        view.buffers[name] = (buf.addr, stable)
        return buf.addr

    def free(self, rank: int, name: str) -> None:
        view = self.views[rank]
        addr, _ = view.buffers.pop(name)
        view.mem.free(addr)
        if rank == self.active_rank:
            self.physical.pop(addr, None)

    def addr_of(self, rank: int, name: str) -> int:
        return self.views[rank].buffers[name][0]

    # ---------------------------------------------------------------- content
    def write(self, rank: int, name: str, data: np.ndarray) -> None:
        assert rank == self.active_rank, "only the resident rank executes"
        self.physical[self.addr_of(rank, name)] = np.array(data, copy=True)

    def read(self, rank: int, name: str) -> np.ndarray:
        """Read a buffer: from physical memory if resident content matches the
        rank's view, else from the host store."""
        view = self.views[rank]
        addr, _ = view.buffers[name]
        if rank == self.active_rank and addr in self.physical:
            return self.physical[addr]
        want = view.expected.get(name)
        if want is not None and addr in self.physical \
                and buffer_checksum(self.physical[addr]) == want:
            return self.physical[addr]
        if want is not None:
            return self.host.get(want)
        return self.physical[addr]

    # ---------------------------------------------------------------- switch
    def context_switch(self, to_rank: int) -> None:
        """Conditional swap-out of the resident rank, conditional swap-in of
        ``to_rank`` (§5.2.1)."""
        from_rank = self.active_rank
        if from_rank == to_rank:
            return
        self.metrics.context_switches += 1
        fv = self.views[from_rank]
        for name, (addr, stable) in list(fv.buffers.items()):
            if addr not in self.physical:
                continue
            data = self.physical[addr]
            cs = buffer_checksum(data)
            fv.expected[name] = cs
            if self.host.has(cs):
                self.metrics.elided_swapouts += 1
            else:
                self.host.put(data)
                self.metrics.swapout_bytes += data.nbytes
            # buffer marked unused; lazily GC'd — content stays resident so
            # the incoming rank can elide its swap-in (paper §5.2.1)

        tv = self.views[to_rank]
        for name, (addr, stable) in tv.buffers.items():
            want = tv.expected.get(name)
            if want is None:
                continue
            cur = self.physical.get(addr)
            if cur is not None and buffer_checksum(cur) == want:
                self.metrics.elided_swapins += 1           # same content, same addr
                continue
            moved = False
            for a2, d2 in self.physical.items():
                if a2 != addr and buffer_checksum(d2) == want:
                    self.physical[addr] = np.array(d2, copy=True)
                    self.metrics.d2d_moves += 1
                    self.metrics.elided_swapins += 1       # avoided host swap-in
                    moved = True
                    break
            if not moved:
                data = self.host.get(want)
                self.physical[addr] = np.array(data, copy=True)
                self.metrics.swapin_bytes += data.nbytes
        self.active_rank = to_rank


class SplicedTrainer:
    """A DP training job spliced onto one device — the end-to-end choreography.

    The workload is a real (numpy) model: params P, momentum O, per-rank
    gradients from rank-specific data shards.  Each mini-batch:

      for each resident rank (time-slice):
          variable-sized transient allocs (exercise §5.2.2)
          compute grads on the rank's shard; accumulate into proxy scratch
          sync point -> context switch
      last rank: allreduce(accumulated) [engine-level], optimizer update
                 (squashed on all but the root rank)
    """

    def __init__(self, n_ranks: int, dim: int = 64, capacity: int = 1 << 22,
                 seed: int = 0, squash: bool = True,
                 update_fn: Optional[Callable] = None):
        self.n = n_ranks
        self.dim = dim
        self.squash = squash
        self.squash_disabled_reason: Optional[str] = None
        self.device = SplicedDevice(capacity, list(range(n_ranks)))
        self.rng = np.random.Generator(np.random.Philox(seed))
        self.lr = 0.05
        self.momentum = 0.9
        self.update_fn = update_fn or self._sgd_momentum_update
        self.minibatch_idx = 0

        p0 = self.rng.standard_normal(dim).astype(np.float32)
        o0 = np.zeros(dim, np.float32)
        self.target = self.rng.standard_normal(dim).astype(np.float32)
        cs_p, cs_o = buffer_checksum(p0), buffer_checksum(o0)
        self.device.host.put(p0)
        self.device.host.put(o0)
        for r in range(n_ranks):
            self.device.alloc(r, "P", p0.nbytes, stable=True)
            self.device.alloc(r, "O", o0.nbytes, stable=True)
            self.device.views[r].expected["P"] = cs_p
            self.device.views[r].expected["O"] = cs_o
        # make rank 0 resident with initial content
        self.device.physical[self.device.addr_of(0, "P")] = p0.copy()
        self.device.physical[self.device.addr_of(0, "O")] = o0.copy()
        self.scratch = np.zeros(dim, np.float32)     # proxy-owned accumulator

    # -- workload pieces ------------------------------------------------------
    def _grad(self, rank: int) -> np.ndarray:
        g = np.random.Generator(np.random.Philox(
            key=7, counter=[0, 0, self.minibatch_idx, rank]))
        x = g.standard_normal(self.dim).astype(np.float32)
        p = self.device.read(rank, "P")
        return (p - self.target) * 0.5 + 0.01 * x

    def _sgd_momentum_update(self, p, o, g, rank):
        o = self.momentum * o + g
        return p - self.lr * o, o

    # -- one mini-batch ---------------------------------------------------------
    def run_minibatch(self, validate: bool = False) -> Dict:
        dev = self.device
        squash = self.squash and not validate \
            and self.squash_disabled_reason is None
        self.scratch[:] = 0
        mutation_records: Dict[int, Dict[str, Tuple[int, str]]] = {}

        for r in range(self.n):
            dev.context_switch(r)
            act_elems = 64 * (1 + int(self.rng.integers(0, 4)) + r % 3)
            dev.alloc(r, "act", act_elems * 4, stable=False)
            dev.write(r, "act", np.zeros(act_elems, np.float32))
            g = self._grad(r)
            self.scratch += g                        # proxy-local accumulation
            dev.free(r, "act")

        dev.metrics.allreduces_issued += 1           # one real allreduce/device
        g_avg = self.scratch / self.n

        root = self.n - 1                            # currently resident
        update_ranks = [root] if squash else list(range(self.n))
        for r in update_ranks:
            dev.context_switch(r)
            before = {name: buffer_checksum(dev.read(r, name))
                      for name in ("P", "O")}
            p, o = dev.read(r, "P"), dev.read(r, "O")
            new_p, new_o = self.update_fn(p, o, g_avg, r)
            dev.write(r, "P", new_p)
            dev.write(r, "O", new_o)
            dev.metrics.executed_update_ops += 1
            after = {name: (dev.addr_of(r, name),
                            buffer_checksum(dev.read(r, name)))
                     for name in ("P", "O")}
            mutation_records[r] = {
                name: after[name] for name in after if after[name][1] != before[name]}
        if squash:
            dev.metrics.squashed_ops += self.n - 1
            # squashed ranks see the root's update through shared addresses:
            # their expected content IS the root's new content (§5.2.3 (a),(b))
            for r in range(self.n):
                for name in ("P", "O"):
                    dev.views[r].expected[name] = buffer_checksum(
                        dev.read(root, name))
        else:
            for r in range(self.n):
                for name in ("P", "O"):
                    dev.views[r].expected[name] = buffer_checksum(
                        dev.read(r, name))

        self.minibatch_idx += 1
        return {"mutations": mutation_records,
                "grad_norm": float(np.linalg.norm(g_avg))}

    # -- views ------------------------------------------------------------------
    def params(self, rank: int) -> np.ndarray:
        return np.asarray(self.device.read(rank, "P"))

    def stable_addresses(self, rank: int) -> Dict[str, int]:
        return {n: a for n, (a, st) in self.device.views[rank].buffers.items()
                if st}
