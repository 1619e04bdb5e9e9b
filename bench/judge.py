"""The comparison that decides ``correct``: the program's first steps
against the plain reference's, on the same weights and batches.

Four numbers, each held to a limit of the cell's own where its workload
file gives one (``limits``):

- ``loss_gap``: the largest gap, in nats, between the program's loss and
  the reference's over the compared steps;
- ``grad1_gap``: by the worst leaf but the embedding table, the gap
  between the norms of the two step-1 gradients before the global clip,
  over the reference's norm of that leaf or of the median leaf, whichever
  is larger;
- ``embed_grad1_gap``: the same for the embedding table alone, over its
  own reference norm.  The program sums the lookup's gradient in the bf16
  the configuration states, so this leaf reads about ten times the
  others and is held apart, to a limit of its own;
- ``change_gap``: as ``grad1_gap`` for the norm of each leaf's change over
  the compared steps, the embedding table included, leaving out the
  leaves whose reference step-1 gradient is under a thousandth of the
  median leaf's (their change is round-off under Adam).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

NAMES = ("loss_gap", "grad1_gap", "embed_grad1_gap", "change_gap")
QUIET_LEAF = 1e-3
EMBED = "embed"


def _worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
                leaves) -> float:
    floor = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor) for k in leaves)


def gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """The four numbers of ``prog``'s readings against ``ref``'s (each a
    dict with ``losses``, ``grad1``, the step-1 gradient's norm of each
    leaf before the clip, and ``change``).  A reading that is not finite,
    or a leaf missing on one side, gives inf."""
    values = [*prog["losses"], *prog["grad1"].values(),
              *prog["change"].values()]
    if set(prog["grad1"]) != set(ref["grad1"]) or \
            len(prog["losses"]) != len(ref["losses"]) or \
            not all(math.isfinite(x) for x in values):
        return {name: math.inf for name in NAMES}
    g = ref["grad1"]
    quiet = QUIET_LEAF * statistics.median(g.values())
    moving = [k for k in g if g[k] >= quiet]
    return {"loss_gap": max(abs(a - b) for a, b in zip(prog["losses"],
                                                       ref["losses"])),
            "grad1_gap": _worst_leaf(prog["grad1"], g,
                                     [k for k in g if k != EMBED]),
            "embed_grad1_gap": abs(prog["grad1"][EMBED] - g[EMBED])
            / g[EMBED],
            "change_gap": _worst_leaf(prog["change"], ref["change"], moving)}


def holds(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number that has a limit within it.  A number without one is
    reported and not compared; a cell with no limit never holds."""
    return bool(limits) and all(numbers[name] <= limit
                                for name, limit in limits.items())
