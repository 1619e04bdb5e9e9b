"""Conservative validation of squashing (§5.2.3).

Squashing alters the execution sequence using domain knowledge, so it must
be *provably* safe or disabled.  The paper's approach: run the first (and
every k-th) mini-batch with squashing DISABLED, infer the effect of the
squashing-window operations post-facto from buffer content checksums, and
enforce:

  1. all buffer mutations during the window are identical across resident
     ranks — same addresses, same sizes, same checksums;
  2. device-to-host copies during the window are identical across ranks.

If validation fails the model is marked unsafe and the engine permanently
falls back to swap-based switching: a potential correctness problem becomes
a measurable performance problem, never silent corruption.

A copy of ``repro.core.validation``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.splicing import SplicedTrainer


@dataclasses.dataclass
class ValidationReport:
    ok: bool
    reason: Optional[str] = None
    n_ranks_checked: int = 0
    n_buffers_checked: int = 0


def validate_squashing_window(mutations: Dict[int, Dict[str, Tuple[int, str]]],
                              d2h_copies: Optional[Dict[int, list]] = None
                              ) -> ValidationReport:
    """Check invariants over per-rank mutation records from a validation
    mini-batch: {rank: {buffer_name: (addr, checksum_after)}}."""
    ranks = sorted(mutations)
    if not ranks:
        return ValidationReport(ok=True, n_ranks_checked=0)
    ref = mutations[ranks[0]]
    for r in ranks[1:]:
        mr = mutations[r]
        if set(mr) != set(ref):
            return ValidationReport(
                ok=False, reason=f"rank {r} mutated different buffer set "
                f"{sorted(mr)} vs {sorted(ref)}", n_ranks_checked=len(ranks))
        for name in ref:
            if mr[name] != ref[name]:
                return ValidationReport(
                    ok=False, reason=f"rank {r} buffer {name}: "
                    f"{mr[name]} != {ref[name]}", n_ranks_checked=len(ranks))
    if d2h_copies:
        ref_d2h = d2h_copies.get(ranks[0], [])
        for r in ranks[1:]:
            if d2h_copies.get(r, []) != ref_d2h:
                return ValidationReport(
                    ok=False, reason=f"rank {r} divergent D2H copies",
                    n_ranks_checked=len(ranks))
    return ValidationReport(ok=True, n_ranks_checked=len(ranks),
                            n_buffers_checked=len(ref))


def run_validated_training(trainer: SplicedTrainer, n_minibatches: int,
                           validate_every: int = 8) -> Dict:
    """Drive a spliced trainer with conservative validation: mini-batch 0
    (and every k-th) runs unsquashed + checked; a failure permanently
    disables squashing (fallback to swap mode)."""
    reports = []
    for mb in range(n_minibatches):
        is_validation = (mb % validate_every == 0) \
            and trainer.squash_disabled_reason is None
        out = trainer.run_minibatch(validate=is_validation)
        if is_validation:
            rep = validate_squashing_window(out["mutations"])
            reports.append(rep)
            if not rep.ok:
                trainer.squash_disabled_reason = rep.reason
    return {
        "reports": reports,
        "squash_disabled": trainer.squash_disabled_reason,
        "metrics": trainer.device.metrics,
    }
