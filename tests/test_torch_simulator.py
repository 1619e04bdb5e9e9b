"""The port's copies of the fleet simulator and the elastic serving tier
(``scheduler/simulator.py``, ``scheduler/serving.py``) hold the assertions
of ``tests/test_serving_tier.py`` and walk the JAX package's decisions.

Each test of ``tests/test_serving_tier.py`` is here once, parametrised over
the two packages (``repro`` and ``repro_torch``), with the same body for
both; each package's defaults are its own (the port's ``GpuSpec`` is the
H100 data sheet, JAX's the v5e), and every assertion holds for either
(the decision digests fold node spans too, as ``benchmarks/sched_scale.py``
folds them, where ``tests/test_serving_tier.py`` folds without).  A
seeded trace with failures, the serving tier and scaling curves on gives
the same digest of every decision and the same ``SimResult`` from both,
under one explicit ``GpuSpec`` (``scenarios.TRACE_GPU``).  No JAX is
needed: the modules are numpy (``tests/test_torch_copies.py`` holds them
equal by AST).
"""
import dataclasses
import importlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro_torch.scheduler.scenarios import DigestPolicy, seeded_fleet_trace

PACKAGES = ["repro", "repro_torch"]
SRC = Path(__file__).resolve().parents[1] / "src"
TRAFFIC_SEED = 11
HORIZON = 24 * 3600.0


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _services(pkg):
    """``tests/test_serving_tier.py``'s two toy services, built from the
    package's own ``ReplicaProfile`` and ``ServiceSpec``."""
    profile = _mod(pkg, "serving.engine").ReplicaProfile(
        name="toy", gpus_per_replica=8, batch=64, p99_decode_seconds=0.03,
        tokens_per_second=2000.0, qps_per_replica=16.0,
        weight_bytes=8 << 30)
    spec = _mod(pkg, "scheduler.serving").ServiceSpec
    return [spec("chat", profile, peak_qps=16.0 * 8),
            spec("code", profile, peak_qps=16.0 * 5)]


def _run(pkg, autoscaler="predictive", loaning=True, vec_policy=True,
         job_table=True, horizon=HORIZON, digest=False):
    sim_mod = _mod(pkg, "scheduler.simulator")
    serving = _mod(pkg, "scheduler.serving")
    fleet = sim_mod.make_fleet(2, 2, 512, gpus_per_node=8)
    jobs = sim_mod.synth_workload(500, fleet.total(), seed=3,
                                  mean_interarrival=90.0, work_scale=0.3)
    scfg = serving.ServingConfig(
        services=_services(pkg),
        traffic=serving.TrafficConfig(seed=TRAFFIC_SEED),
        autoscaler=autoscaler, loaning=loaning)
    cfg = sim_mod.SimConfig(horizon_seconds=horizon, vectorized=True,
                            job_table=job_table, serving=scfg)
    policy = _mod(pkg, "scheduler.policy").ElasticPolicy(
        vectorized=vec_policy, cost_model=cfg.costs())
    if digest:
        policy = DigestPolicy(policy)
    sim = sim_mod.FleetSimulator(fleet, jobs, policy, cfg)
    return sim.run(), sim, policy


# -- 1. analytic model ----------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_qps_to_replicas_monotone(pkg):
    cfg = _mod(pkg, "configs").get_config("olmo-1b")
    prof = _mod(pkg, "serving.engine").ReplicaProfile.from_config(
        cfg, slo_ms=30.0)
    assert prof.qps_per_replica > 0
    assert prof.p99_decode_seconds <= 0.030
    qps = np.linspace(0.0, 20 * prof.qps_per_replica, 50)
    reps = [prof.replicas_for(q) for q in qps]
    assert all(b >= a for a, b in zip(reps, reps[1:]))
    assert prof.replicas_for(prof.qps_per_replica) == 1
    assert prof.replicas_for(prof.qps_per_replica + 1e-6) == 2
    assert prof.replicas_for(qps[-1], utilization=0.5) >= prof.replicas_for(
        qps[-1], utilization=1.0)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_decode_roofline_monotone(pkg):
    engine = _mod(pkg, "serving.engine")
    cfg = _mod(pkg, "configs").get_config("yi-9b")
    g = engine.min_gpus_for_memory(cfg)
    assert g & (g - 1) == 0
    steps = [engine.decode_step_seconds(cfg, b, g) for b in (1, 8, 64, 256)]
    assert all(b > a for a, b in zip(steps, steps[1:]))
    assert engine.decode_step_seconds(cfg, 8, g, context_len=8192) > \
        engine.decode_step_seconds(cfg, 8, g, context_len=512)
    assert engine.decode_step_seconds(cfg, 8, 2 * g) < \
        engine.decode_step_seconds(cfg, 8, g)
    loose = engine.ReplicaProfile.from_config(cfg, slo_ms=60.0)
    tight = engine.ReplicaProfile.from_config(cfg, slo_ms=40.0)
    assert tight.qps_per_replica / tight.gpus_per_replica <= (
        loose.qps_per_replica / loose.gpus_per_replica)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_traffic_trace_deterministic_and_bounded(pkg):
    serving = _mod(pkg, "scheduler.serving")
    services = _services(pkg)
    tcfg = serving.TrafficConfig(seed=TRAFFIC_SEED)
    a = serving.TrafficTrace(services, tcfg, HORIZON)
    b = serving.TrafficTrace(services, tcfg, HORIZON)
    assert np.array_equal(a.qps, b.qps)
    other = serving.TrafficTrace(
        services, serving.TrafficConfig(seed=TRAFFIC_SEED + 1), HORIZON)
    assert not np.array_equal(a.qps, other.qps)
    for i, spec in enumerate(services):
        assert a.qps[i].min() >= tcfg.trough_fraction * spec.peak_qps - 1e-9
        assert a.qps[i].max() <= spec.peak_qps * tcfg.spike_amplitude[1] + 1e-9
    assert np.all(a.window_peak(0.0, 3600.0) <= a.peak() + 1e-9)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_traffic_trace_rejects_queries_past_horizon(pkg):
    serving = _mod(pkg, "scheduler.serving")
    services = _services(pkg)
    trace = serving.TrafficTrace(
        services, serving.TrafficConfig(seed=TRAFFIC_SEED), 3600.0)
    end = trace.end_seconds
    assert end >= 3600.0
    trace.at(end)
    horizon = trace.horizon_seconds
    assert horizon == 3600.0
    short = trace.window_peak(horizon, horizon + 600.0)
    assert short.shape == (len(services),)
    assert np.array_equal(short, trace.window_peak(horizon, end))
    with pytest.raises(ValueError):
        trace.at(end + 1.0)
    with pytest.raises(ValueError):
        trace.window_peak(horizon + 1.0, horizon + 600.0)
    with pytest.raises(ValueError):
        trace.window_peak(end + 1.0, end + 600.0)
    for now in np.arange(0.0, 2 * 3600.0, 300.0):
        if now > end:
            with pytest.raises(ValueError):
                trace.at(float(now))
            break
        trace.at(float(now))
    else:  # pragma: no cover - the trace would have to cover 2h
        raise AssertionError("guard never engaged")


@pytest.mark.parametrize("pkg", PACKAGES)
def test_holt_forecaster_leads_a_ramp(pkg):
    serving = _mod(pkg, "scheduler.serving")
    spec = _services(pkg)[:1]
    table = serving.ServiceTable(spec, reserved_replicas=np.array([64]))
    cfg = serving.ServingConfig(services=spec, scale_down_ticks=1)
    targets = [int(table.retarget(cfg, np.array([float(q)]))[0])
               for q in range(10, 200, 10)]
    reactive = serving.ServingConfig(services=spec, autoscaler="reactive",
                                     scale_down_ticks=1)
    rtable = serving.ServiceTable(spec, reserved_replicas=np.array([64]))
    rtargets = [int(rtable.retarget(reactive, np.array([float(q)]))[0])
                for q in range(10, 200, 10)]
    assert targets[-1] > rtargets[-1]
    assert all(p >= r for p, r in zip(targets[3:], rtargets[3:]))


# -- 2. reclaim beats the deadline ---------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_reclaim_beats_deadline_under_spikes(pkg):
    res, _, _ = _run(pkg, "predictive", loaning=True)
    assert res.serving_windows > 0
    assert res.serving_reclaims > 0
    assert res.serving_reclaim_deadline_seconds > 0
    assert res.serving_reclaim_max_seconds <= \
        res.serving_reclaim_deadline_seconds
    assert res.serving_reclaims_over_deadline == 0
    assert res.serving_slo_attainment >= 0.99


# -- 3. loaned capacity is conserved -------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_loaned_capacity_conservation(pkg):
    res, sim, _ = _run(pkg, "predictive", loaning=True)
    hours = HORIZON / 3600.0
    assert res.serving_loaned_gpu_hours > 0.0
    assert res.serving_loaned_gpu_hours <= res.serving_reserved_gpus * hours
    assert res.serving_gpu_hours <= res.serving_reserved_gpus * hours + 1e-6
    noloan, sim_n, _ = _run(pkg, "predictive", loaning=False)
    assert noloan.serving_loaned_gpu_hours == 0.0
    assert noloan.serving_reclaims == 0
    train = sim.busy_gpu_seconds / 3600.0 - res.serving_gpu_hours
    train_noloan = sim_n.busy_gpu_seconds / 3600.0 - noloan.serving_gpu_hours
    assert train > train_noloan


# -- 4. digest equivalence with services active --------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_policy_paths_equivalent_with_services(pkg):
    digests, signatures = {}, {}
    for vec_policy in (True, False):
        for job_table in (True, False):
            res, _, policy = _run(pkg, "predictive", loaning=True,
                                  vec_policy=vec_policy, job_table=job_table,
                                  horizon=8 * 3600.0, digest=True)
            key = (vec_policy, job_table)
            digests[key] = policy.digest()
            signatures[key] = (res.serving_windows, res.serving_violations,
                               res.serving_reclaims,
                               round(res.serving_loaned_gpu_hours, 6),
                               res.preemptions, res.migrations, res.completed)
    ref = digests[(True, True)]
    assert all(d == ref for d in digests.values()), digests
    sig = signatures[(True, True)]
    assert all(s == sig for s in signatures.values()), signatures


# -- 5. predictive beats reactive ----------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_predictive_beats_reactive_attainment(pkg):
    pred, _, _ = _run(pkg, "predictive", loaning=True)
    react, _, _ = _run(pkg, "reactive", loaning=True)
    assert pred.serving_windows == react.serving_windows
    assert pred.serving_violations < react.serving_violations
    assert pred.serving_slo_attainment > react.serving_slo_attainment


@pytest.mark.parametrize("pkg", PACKAGES)
def test_reclaim_deadline_is_cost_model_charged(pkg):
    serving = _mod(pkg, "scheduler.serving")
    CostModel = _mod(pkg, "scheduler.costs").CostModel
    services = _services(pkg)
    scfg = serving.ServingConfig(
        services=services, traffic=serving.TrafficConfig(seed=TRAFFIC_SEED))
    tier = serving.ServingTier(scfg, tick_seconds=10.0,
                               horizon_seconds=HORIZON, costs=CostModel())
    assert tier.reclaim_deadline() > 10.0
    pinned = serving.ServingConfig(
        services=services, traffic=serving.TrafficConfig(seed=TRAFFIC_SEED),
        reclaim_deadline_seconds=123.0)
    tier2 = serving.ServingTier(pinned, 10.0, HORIZON, CostModel())
    assert tier2.reclaim_deadline() == 123.0


# -- the port walks JAX's decisions ---------------------------------------


def test_seeded_trace_walks_the_same_decisions_as_jax():
    """One seeded trace (failures, snapshots, the serving tier with
    loaning, concave curves, node placement) through both simulators: the
    digest of every decision and every ``SimResult`` field are equal.
    The trace exercises what it claims: failures kill jobs, the services
    reclaim loaned GPUs, and jobs are preempted, migrated and resized."""
    runs = {pkg: seeded_fleet_trace(
        lambda m, pkg=pkg: importlib.import_module(f"{pkg}.{m}"))
        for pkg in PACKAGES}
    (jd, jres, jn), (pd, pres, pn) = runs["repro"], runs["repro_torch"]
    assert (pd, pn) == (jd, jn)
    assert repr(dataclasses.asdict(pres)) == repr(dataclasses.asdict(jres))
    assert jn > 100 and jres.job_failures > 0 and jres.serving_reclaims > 0
    assert jres.serving_loaned_gpu_hours > 0 and jres.snapshots > 0
    assert min(jres.preemptions, jres.migrations, jres.resizes) > 0


def test_simulator_imports_without_the_model_code():
    code = ("import sys, repro_torch.scheduler.simulator\n"
            "from repro_torch.scheduler import FleetSimulator, ServingTier\n"
            "bad = [m for m in sys.modules if m.startswith("
            "('repro_torch.models', 'jax')) or m.split('.')[0] == 'repro']\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(SRC)))
    assert proc.returncode == 0, proc.stdout + proc.stderr
