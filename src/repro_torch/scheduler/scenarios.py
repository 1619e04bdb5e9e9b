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

``seeded_fleet_trace`` is the fleet simulator's counterpart: one seeded
trace with failures, the serving tier and scaling curves on, reduced to
a digest of every decision and the ``SimResult``.  It gives the same
digest and result through either package's simulator, under one explicit
``GpuSpec`` (``tests/test_torch_simulator.py``); ``chip_smoke.py`` runs it
on the card's machine, which has no JAX.

This module imports nothing of the executors or the simulator: the caller
passes them in.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Tuple


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


# The serving tier's replica profiles come from the analytic decode
# roofline, whose default ``GpuSpec`` differs between the two packages by
# design (the port's is the H100 data sheet); the trace fixes its fields.
TRACE_GPU = dict(name="trace", hbm_bytes=int(80e9), hbm_bandwidth=3.35e12,
                 flops=989e12, mfu=0.4, step_overhead_seconds=3e-4)
# (service, arch, p99 SLO ms, diurnal peak qps)
TRACE_SERVICES = (("chat", "yi-9b", 40.0, 4000.0),
                  ("embed", "olmo-1b", 30.0, 6000.0))


class DigestPolicy:
    """Wraps a policy and folds every ``Decision`` (allocations,
    preemptions, migrations and node spans) into a running sha256, as
    ``benchmarks/sched_scale.py``'s equivalence gate folds them."""

    def __init__(self, inner):
        self.inner = inner
        self.name = inner.name
        self.decisions = 0
        self._digest = hashlib.sha256()

    def bind_costs(self, cost_model, interval_hint) -> None:
        self.inner.bind_costs(cost_model, interval_hint)

    def bind_telemetry(self, telemetry) -> None:
        if hasattr(self.inner, "bind_telemetry"):
            self.inner.bind_telemetry(telemetry)

    def decide(self, now, jobs, fleet):
        decision = self.inner.decide(now, jobs, fleet)
        spans = None
        if decision.node_plan is not None:
            _, released, assigns = decision.node_plan
            spans = (sorted(int(r) for r in released),
                     [(int(r), [int(n) for n in ns], [int(g) for g in gs])
                      for r, ns, gs in assigns])
        self._digest.update(repr((sorted(decision.alloc.items()),
                                  decision.preemptions, decision.migrations,
                                  spans)).encode())
        self.decisions += 1
        return decision

    def digest(self) -> str:
        return self._digest.hexdigest()


def seeded_fleet_trace(load: Callable, n_jobs: int = 240,
                       horizon_hours: float = 12.0) -> Tuple[str, object, int]:
    """One seeded trace through a package's ``FleetSimulator``: a 1,024-GPU
    fleet of 4 clusters in 2 regions, ``n_jobs`` training jobs with
    concave scaling curves, device, node and cluster failures with a
    Young-Daly snapshot cadence, and two latency-SLO services (yi-9b and
    olmo-1b operating points under ``TRACE_GPU``) whose predictive
    autoscaler loans their idle quota to training.

    ``load(name)`` returns the package's module ``name`` (for example
    ``"scheduler.simulator"``).  Returns (decision digest, ``SimResult``,
    number of decisions).
    """
    sim_mod = load("scheduler.simulator")
    serving = load("scheduler.serving")
    rel = load("scheduler.reliability")
    engine = load("serving.engine")
    get_config = load("configs").get_config
    gpu = engine.GpuSpec(**TRACE_GPU)
    services = [serving.ServiceSpec(
        name, engine.ReplicaProfile.from_config(get_config(arch), slo,
                                                gpu=gpu), peak_qps=peak)
        for name, arch, slo, peak in TRACE_SERVICES]
    fleet = sim_mod.make_fleet(2, 2, 256, gpus_per_node=8)
    horizon = horizon_hours * 3600.0
    jobs = sim_mod.synth_workload(n_jobs, fleet.total(), seed=5,
                                  mean_interarrival=horizon / n_jobs,
                                  work_scale=0.3, curves=True)
    failures = rel.FailureModel(device_mtbf_seconds=30 * 86400.0,
                                node_mtbf_seconds=4 * 86400.0,
                                cluster_mtbf_seconds=5 * 86400.0, seed=7)
    costs = load("scheduler.costs").CostModel()
    cfg = sim_mod.SimConfig(
        horizon_seconds=horizon, cost_model=costs, failures=failures,
        cadence=rel.CheckpointCadence(cost_model=costs,
                                      failure_model=failures),
        serving=serving.ServingConfig(
            services=services, traffic=serving.TrafficConfig(seed=9)))
    policy = DigestPolicy(load("scheduler.policy").ElasticPolicy(
        vectorized=True, cost_model=costs))
    result = sim_mod.FleetSimulator(fleet, jobs, policy, cfg).run()
    return policy.digest(), result, policy.decisions
