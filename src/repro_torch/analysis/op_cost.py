"""Per-device cost of a traced step, by aten op (the counterpart of
``repro.analysis.hlo_cost``, which parses XLA's HLO; eager PyTorch has no
HLO, so the ops are counted as they run).

``OpCost`` is a ``TorchDispatchMode``.  It gives way to DTensor (it
returns ``NotImplemented`` for an op on DTensors, as DTensor's
``CommDebugMode`` does), so it sees each op after DTensor has turned it
into the op on this device's local shards and the collectives of its
redistributions: every count is per device, from local shapes.  A mesh
dim on which an op's operands are replicated does the whole of its work on
every device, so nothing is divided by it.

- FLOPs: every matmul (``mm``, ``addmm``, ``bmm``, ``baddbmm`` and the
  in-place ``addmm_`` and ``baddbmm_``) =
  2 x prod(result dims) x the contracted dim, as ``hlo_cost.py`` counts
  dots.
- Bytes: operands + results of every op that is not a view.  XLA counts a
  fusion at its call site only (its internal traffic stays in registers);
  eager mode runs and counts every elementwise op, so these bytes read
  higher than a fused program's would, by design.
- Bytes lower (``hlo_cost.py``'s write-once/read-once bound, the traffic
  of a perfectly fused program): 2 x the result bytes of every op that is
  not a view, and a matmul's operands + result.
- The kernels' ops (namespace ``repro_torch``, ``kernels/_library.py``):
  the FLOPs and bytes of their formulas (``COSTS``), for both byte counts,
  in place of the rules above; their outputs are live as any op's.  Under
  fake tensors they run their fake implementations, so the trace holds
  what the kernel holds (its outputs), not its plain version's
  intermediates.  ``kernels`` counts their calls by name.
- Collective bytes: the result bytes of each ``c10d_functional``
  collective, by type (JAX's names: all-gather, reduce-scatter,
  all-reduce, all-to-all, collective-permute).
- Live bytes: the storages the ops create, each counted from its creation
  until it is freed, plus any tensors given to ``track``; ``peak_bytes``
  is the most at once (the dry-run's memory per device).

In eager mode every loop iteration runs, so there are no trip counts to
recover (``hlo_cost.py``'s ``known_trip_count``).  DTensor infers an op's
output shape by running it once on fake global tensors; those runs are
not device work and are not counted.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import Counter
from typing import Dict, Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels._library import COSTS, NAMESPACE

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-permute",
}
# lhs arg index; the in-place forms accumulate into their first argument
_MATMULS = {"mm": 0, "addmm": 1, "bmm": 0, "baddbmm": 1, "addmm_": 1,
            "baddbmm_": 1}


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0            # operands + results, every op
    bytes_lower: float = 0.0      # write-once/read-once (perfect fusion)
    coll_bytes: float = 0.0
    coll_by_type: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "bytes": self.bytes,
                "bytes_lower": self.bytes_lower,
                "coll_bytes": self.coll_bytes,
                "coll_by_type": dict(self.coll_by_type)}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor_type(cls) -> bool:
    return cls.__name__ == "DTensor"


class OpCost(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.ops: Counter = Counter()
        self.kernels: Counter = Counter()
        self.live = 0
        self.peak_bytes = 0
        self._seen: Dict[int, int] = {}
        self._quiet = 0
        self._unpatch = None

    def __enter__(self):
        self._patch_shape_inference()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._unpatch is not None:
                self._unpatch()
                self._unpatch = None

    def _patch_shape_inference(self) -> None:
        """Leave out DTensor's shape inference (its fake global runs)."""
        if not torch.distributed.is_available():
            return
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name)

        def quiet(prop, *args, **kwargs):
            self._quiet += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                self._quiet -= 1

        setattr(ShardingPropagator, name, quiet)
        self._unpatch = lambda: setattr(ShardingPropagator, name, orig)

    # ---------------------------------------------------------- memory
    def _hold(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def track(self, tensors: Iterable) -> int:
        """Count ``tensors`` (DTensors by their local shards) as live from
        now on; returns their bytes."""
        total = 0
        for t in tensors:
            if not isinstance(t, torch.Tensor):
                continue
            local = getattr(t, "_local_tensor", t)
            before = self.live
            self._hold(local)
            total += self.live - before
        return total

    # ---------------------------------------------------------- counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._quiet or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        name = func.__name__.split(".")[0]
        self.ops[name] += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                b = float(sum(_nbytes(t) for t in outs))
                self.cost.coll_bytes += b
                self.cost.coll_by_type[kind] += b
            for t in outs:
                self._hold(t)
            return out
        if func.namespace == NAMESPACE:
            cost = COSTS[name](*args, **kwargs)
            self.kernels[name] += 1
            self.cost.flops += float(cost.flops)
            self.cost.bytes += float(cost.bytes)
            self.cost.bytes_lower += float(cost.bytes)
            for t in outs:
                self._hold(t)
            return out
        if name in _MATMULS:
            lhs = args[_MATMULS[name]]
            self.cost.flops += 2.0 * outs[0].numel() * lhs.shape[-1]
        if not func.is_view:
            # an ``out=`` tensor is written, not read: counted with outs
            ins = [t for t in tree_leaves(
                       (args, {k: v for k, v in kwargs.items() if k != "out"}))
                   if isinstance(t, torch.Tensor)]
            moved = float(sum(_nbytes(t) for t in ins + outs))
            self.cost.bytes += moved
            self.cost.bytes_lower += (moved if name in _MATMULS else
                                      2.0 * sum(_nbytes(t) for t in outs))
            for t in outs:
                self._hold(t)
        return out
