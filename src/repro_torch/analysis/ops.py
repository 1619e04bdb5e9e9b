"""Op histograms and collective bytes of a traced step (the counterpart of
``repro.analysis.hlo``, which reads them off XLA's HLO text; here they
come from ``op_cost.OpCost``, which counts them as the ops run)."""
from __future__ import annotations

from typing import Dict

from repro_torch.analysis.op_cost import COLLECTIVES, OpCost


def collective_bytes(counter: OpCost) -> Dict[str, float]:
    """Per-collective-type result bytes, with their ``total`` and the
    ``count`` of collective ops."""
    out: Dict[str, float] = dict(counter.cost.coll_by_type)
    out["count"] = sum(n for name, n in counter.ops.items()
                       if name in ("all_reduce", "all_gather_into_tensor",
                                   "reduce_scatter_tensor",
                                   "all_to_all_single", "broadcast"))
    out["total"] = sum(out[c] for c in COLLECTIVES)
    return out


def op_histogram(counter: OpCost, top: int = 0) -> Dict[str, int]:
    """Op name -> calls, most called first (``top`` > 0 keeps that many),
    and the kernels' ops (``repro_torch::*``) by name whatever their
    rank."""
    items = dict(counter.ops.most_common(top or None))
    items.update((name, counter.ops[name]) for name in counter.kernels)
    return items
