"""The executor's three reference scenarios (those of the JAX package's
``tests/test_executor.py``), written once for both executors.

Each scenario takes the executor's classes and returns its decision log,
a list of ``{"event", "job", "at_step"}`` dicts.  The log depends on no
wall time and no loss value, so the same scenario gives the same log on
the JAX executor, on the port at ``device="cpu"`` and on the port at
``device="cuda"``.  ``chip_smoke.py`` runs them on the card against the
CPU; ``tests/test_torch_executor.py`` runs them on the port against the
JAX executor.  With ``device=None`` the executor is built without a
device (the JAX one has none) and the device check is left out.

This module imports nothing of the executors: the caller passes them in.
"""
from __future__ import annotations

from typing import Dict, List


def _executor(FleetExecutor, total_slots: int, device):
    if device is None:
        return FleetExecutor(total_slots=total_slots)
    return FleetExecutor(total_slots=total_slots, device=device)


def tiered_fleet_with_real_preemption_and_resume(
        FleetExecutor, ManagedJob, TableJob, device=None) -> List[Dict]:
    """A premium mamba2 job preempts a basic olmo job, which is restored at
    the exact step; the premium job's state lives on the executor's
    device."""
    ex = _executor(FleetExecutor, 2, device)
    ex.submit(ManagedJob(id="basic", tier="basic", arch="olmo-1b",
                         world_size=2, total_steps=8))
    ex.tick(); ex.tick()
    basic = ex.jobs["basic"]
    assert basic.allocated == 2 and basic.steps_done >= 2
    ex.submit(ManagedJob(id="prem", tier="premium", arch="mamba2-130m",
                         world_size=2, total_steps=4))
    ex.tick()
    assert ex.jobs["prem"].allocated == 2
    assert basic.allocated == 0 and basic.preemptions == 1
    if device is not None:
        embed = ex.jobs["prem"].runtime.state["params"]["embed"]
        assert embed.device.type == ex.device.type, embed.device
    step_at_preempt = basic.steps_done
    log = ex.run(max_ticks=30)
    assert all(j.done for j in ex.jobs.values())
    events = [e["event"] for e in log]
    assert "preempt" in events and "restore" in events
    restore = next(e for e in log if e["event"] == "restore")
    assert restore["at_step"] == step_at_preempt
    assert basic.steps_done == 8
    return log


def shrink_before_preempt(FleetExecutor, ManagedJob, TableJob,
                          device=None) -> List[Dict]:
    """A standard job shrinks (splice) rather than being evicted."""
    ex = _executor(FleetExecutor, 4, device)
    ex.submit(ManagedJob(id="std", tier="standard", arch="mamba2-130m",
                         world_size=4, total_steps=6))
    ex.tick()
    assert ex.jobs["std"].allocated == 4
    ex.submit(ManagedJob(id="prem", tier="premium", arch="mamba2-130m",
                         world_size=2, total_steps=4))
    ex.tick()
    std = ex.jobs["std"]
    assert ex.jobs["prem"].allocated == 2
    assert std.allocated == 2 and std.resizes == 1
    log = ex.run(max_ticks=30)
    assert std.done and std.steps_done == 6
    return log


def shadows_live_in_job_table_and_resets_propagate(
        FleetExecutor, ManagedJob, TableJob, device=None) -> List[Dict]:
    """Preemption, an injected failure and completion seen through the
    shadow's JobTable view."""
    ex = _executor(FleetExecutor, 2, device)
    ex.submit(ManagedJob(id="job", tier="standard", arch="mamba2-130m",
                         world_size=2, total_steps=8))
    shadow = ex._shadows["job"]
    assert isinstance(shadow, TableJob)
    assert shadow._table is ex.table and ex.table.slots_in_use == 1
    ex.tick(); ex.tick()
    ex.submit(ManagedJob(id="prem", tier="premium", arch="mamba2-130m",
                         world_size=2, total_steps=2))
    ex.tick()
    assert ex.jobs["job"].allocated == 0
    assert shadow.queued_since == ex.clock - ex.tick_seconds
    assert shadow.restore_debt > 0.0
    assert float(ex.table.queued_since[shadow._slot]) == shadow.queued_since
    assert float(ex.table.restore_debt[shadow._slot]) == shadow.restore_debt
    for _ in range(10):
        ex.tick()
        if ex.jobs["job"].allocated > 0 and not ex.jobs["job"].done:
            break
    ex.inject_failure("job")
    assert shadow.failed_at == ex.clock and shadow.failures == 1
    assert shadow.restore_debt == 0.0
    assert bool(ex.table.allocated[shadow._slot] == 0)
    log = ex.run(max_ticks=40)
    assert ex.jobs["job"].done
    assert type(ex._shadows["job"]) is not TableJob
    assert ex.table.slots_in_use == 0
    assert ex._shadows["job"].done_at is not None
    return log


SCENARIOS = (tiered_fleet_with_real_preemption_and_resume,
             shrink_before_preempt,
             shadows_live_in_job_table_and_resets_propagate)
