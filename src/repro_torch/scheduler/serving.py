"""Elastic inference serving tier: SLO replica groups on the shared fleet.

Singularity's §1.1b claim is that inference and training share one
preemptible elastic fleet — the scheduler "elastically shrinks training to
absorb inference load".  This module makes latency-SLO services first-class
scheduler jobs:

* Each service is one guaranteed-tier ``Job`` (``service=True``) whose
  ``demand_gpus`` the simulator retargets every tick from a qps -> replicas
  curve (``ReplicaProfile`` from ``repro.serving.engine``) driven by a
  seeded diurnal+spike ``TrafficTrace``.
* **Capacity loaning** (Aryl, arXiv:2202.07896): the service's *reserved*
  quota covers the trace peak, but off-peak the autoscaler shrinks demand
  below it, and the freed GPUs flow to best-effort training through the
  ordinary allocation passes.  On a spike the retarget raises demand again
  and the policy's guaranteed-first admission preempts the borrowers in the
  same tick — reclaim latency is measured against a deadline charged from
  the ``CostModel``.
* **Predictive pre-warm** (arXiv:2010.05049): a Holt double-exponential
  forecaster (EWMA level + trend, the trend member of the Holt-Winters
  family — our traces are shorter than one seasonal period) raises replicas
  ahead of a ramp so the resize downtime lands *before* the traffic does; a
  reactive baseline scales on the observed qps and eats that warm-up inside
  the SLO window.

Everything here is pure numpy and deliberately policy-agnostic: demand
columns are mutated *before* ``ElasticPolicy.decide`` runs, so the
vectorized and scalar paths (table-backed or plain) see identical inputs
and the decision-digest equivalence gate extends over serving unchanged.

A copy of ``repro.scheduler.serving``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import numpy as np

from repro_torch.scheduler.costs import CostModel, default_checkpoint_bytes
from repro_torch.scheduler.telemetry import C_SPIKE, E_LOAN, E_RECLAIM
from repro_torch.scheduler.types import Job
from repro_torch.serving.engine import ReplicaProfile


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """Seeded diurnal+spike qps generator parameters.

    The diurnal curve is a raised cosine between ``trough_fraction *
    peak_qps`` and ``peak_qps`` with a per-service random phase.  Spikes
    arrive as a Poisson process, multiply the diurnal value by a random
    amplitude, and rise over ``spike_ramp_seconds`` — a *ramp*, not a step,
    so a trend forecaster has something to extrapolate.
    """

    seed: int = 0
    sample_seconds: float = 60.0
    diurnal_period_seconds: float = 86400.0
    trough_fraction: float = 0.35
    spikes_per_day: float = 2.0
    spike_amplitude: tuple = (1.4, 1.6)
    spike_ramp_seconds: float = 600.0
    spike_hold_seconds: float = 900.0
    spike_decay_seconds: float = 900.0


@dataclasses.dataclass(frozen=True)
class ServiceSpec:
    """One latency-SLO service: a replica operating point plus its traffic
    scale.  ``peak_qps`` is the diurnal peak; spikes go above it and the
    reserved quota is sized from the realized trace maximum."""

    name: str
    profile: ReplicaProfile
    peak_qps: float
    min_replicas: int = 1


@dataclasses.dataclass
class ServingConfig:
    """Simulator-side serving tier configuration (``SimConfig.serving``)."""

    services: List[ServiceSpec]
    traffic: TrafficConfig = dataclasses.field(default_factory=TrafficConfig)
    autoscaler: str = "predictive"  # "predictive" | "reactive"
    # loan idle reserved capacity to best-effort training (False pins every
    # service at its reserved quota — the no-loaning baseline)
    loaning: bool = True
    # autoscaler sizes replicas for target_qps / (qps_per_replica * rho):
    # the 1/rho headroom is what absorbs within-window growth
    target_utilization: float = 0.75
    # consecutive ticks below target before scaling down (hysteresis)
    scale_down_ticks: int = 3
    # Holt double-exponential smoothing parameters and pre-warm lead
    holt_alpha: float = 0.6
    holt_beta: float = 0.5
    prewarm_lead_ticks: int = 2
    # fraction of a window the replicas may be warming before the window
    # is charged as an SLO violation
    warm_grace_fraction: float = 0.01
    # override the CostModel-derived reclaim deadline (seconds)
    reclaim_deadline_seconds: Optional[float] = None
    tier: str = "premium"
    # work per service job; large enough that a service never completes
    gpu_hours: float = 1e9
    # replicas are independent: a service schedules as up to this many
    # replica-group *shard* jobs so placement never needs one huge
    # contiguous gang and a spike's growth spreads across clusters
    shards_per_service: int = 4


class TrafficTrace:
    """Precomputed per-service qps series at ``sample_seconds`` resolution.

    Fully determined by (specs, config, horizon): both event loops and all
    policy paths read the same arrays, so serving stays digest-stable.
    """

    def __init__(
        self,
        specs: List[ServiceSpec],
        cfg: TrafficConfig,
        horizon_seconds: float,
    ):
        self.cfg = cfg
        self.sample_seconds = float(cfg.sample_seconds)
        n = int(math.ceil(horizon_seconds / self.sample_seconds)) + 2
        t = np.arange(n) * self.sample_seconds
        rng = np.random.Generator(np.random.Philox(cfg.seed))
        qps = np.zeros((len(specs), n))
        period = cfg.diurnal_period_seconds
        for s, spec in enumerate(specs):
            phase = float(rng.uniform(0.0, period))
            x = 0.5 * (1.0 - np.cos(2.0 * np.pi * (t - phase) / period))
            curve = spec.peak_qps * (
                cfg.trough_fraction + (1.0 - cfg.trough_fraction) * x
            )
            mult = np.ones(n)
            n_spikes = int(rng.poisson(cfg.spikes_per_day * horizon_seconds / 86400.0))
            for _ in range(n_spikes):
                t0 = float(rng.uniform(0.0, horizon_seconds))
                amp = float(rng.uniform(*cfg.spike_amplitude))
                rel = t - t0
                rise = np.clip(rel / cfg.spike_ramp_seconds, 0.0, 1.0)
                fall = np.clip(
                    1.0
                    - (rel - cfg.spike_ramp_seconds - cfg.spike_hold_seconds)
                    / cfg.spike_decay_seconds,
                    0.0,
                    1.0,
                )
                shape = np.where(rel >= 0.0, rise * fall, 0.0)
                mult = np.maximum(mult, 1.0 + (amp - 1.0) * shape)
            qps[s] = curve * mult
        self.qps = qps
        # the horizon the caller asked to cover; windows must START at or
        # before it (the +2-sample padding past it exists only so the
        # final in-simulation window has samples to read, not to serve
        # queries of its own)
        self.horizon_seconds = float(horizon_seconds)
        # last instant the trace covers; queries beyond it are errors,
        # not a silent flat replay of the final sample
        self.end_seconds = float((n - 1) * self.sample_seconds)

    def _check_start(self, t: float, what: str) -> None:
        if t > self.end_seconds:
            raise ValueError(
                f"traffic trace ends at t={self.end_seconds:.0f}s but "
                f"{what} t={t:.0f}s — build the trace with a horizon "
                "covering the simulation"
            )

    def at(self, now: float) -> np.ndarray:
        """Per-service qps observed at wall time ``now``.  Raises
        ``ValueError`` past the trace end instead of replaying the final
        sample forever."""
        self._check_start(now, "queried at")
        i = min(int(now / self.sample_seconds), self.qps.shape[1] - 1)
        return self.qps[:, i]

    def window_peak(self, t0: float, t1: float) -> np.ndarray:
        """Per-service max qps over samples in ``[t0, t1]``.  The window
        START must lie inside the simulated horizon — a start in the
        trailing sample padding (or beyond) raises like ``at`` does,
        instead of silently reading padding samples.  ``t1`` may overhang
        the trace end by part of one scheduler tick (the final
        in-simulation window: with ``t0 <= horizon`` the overhang is
        bounded by ``tick - sample``), in which case the peak covers the
        samples that exist."""
        if t0 > self.horizon_seconds:
            raise ValueError(
                f"traffic trace covers {self.horizon_seconds:.0f}s but "
                f"window starts at t={t0:.0f}s — build the trace with a "
                "horizon covering the simulation"
            )
        i0 = max(0, int(t0 / self.sample_seconds))
        i1 = min(int(math.ceil(t1 / self.sample_seconds)), self.qps.shape[1] - 1)
        return self.qps[:, i0 : i1 + 1].max(axis=1)

    def peak(self) -> np.ndarray:
        """Per-service trace maximum (what the reserved quota must cover)."""
        return self.qps.max(axis=1)


class ServiceTable:
    """SoA of per-service autoscaler + SLO-accounting state (the JobTable
    recipe: fixed columns, vectorized retarget, no per-service objects on
    the hot path)."""

    def __init__(self, specs: List[ServiceSpec], reserved_replicas: np.ndarray):
        n = len(specs)
        self.n = n
        self.names = [s.name for s in specs]
        self.gpus_per_replica = np.array(
            [s.profile.gpus_per_replica for s in specs], dtype=np.int64
        )
        self.qps_per_replica = np.array(
            [s.profile.qps_per_replica for s in specs], dtype=np.float64
        )
        self.min_replicas = np.array(
            [max(1, s.min_replicas) for s in specs], dtype=np.int64
        )
        self.reserved_replicas = np.maximum(
            reserved_replicas.astype(np.int64), self.min_replicas
        )
        # autoscaler state
        self.target_replicas = self.reserved_replicas.copy()
        self.below_ticks = np.zeros(n, dtype=np.int64)
        self.level = np.zeros(n, dtype=np.float64)
        self.trend = np.zeros(n, dtype=np.float64)
        self.seen = np.zeros(n, dtype=bool)
        # SLO window accounting
        self.prev_replicas = self.reserved_replicas.copy()
        self.ok_windows = np.zeros(n, dtype=np.int64)
        self.windows = np.zeros(n, dtype=np.int64)
        # open reclaim deficits (window start, NaN = none open)
        self.deficit_open = np.full(n, np.nan)

    def retarget(self, cfg: ServingConfig, qps_obs: np.ndarray) -> np.ndarray:
        """Advance forecaster state one tick and return replica targets."""
        y = qps_obs
        if cfg.autoscaler == "predictive":
            first = ~self.seen
            self.level[first] = y[first]
            self.trend[first] = 0.0
            self.seen[first] = True
            rest = ~first
            prev_level = self.level[rest]
            self.level[rest] = cfg.holt_alpha * y[rest] + (1.0 - cfg.holt_alpha) * (
                prev_level + self.trend[rest]
            )
            self.trend[rest] = (
                cfg.holt_beta * (self.level[rest] - prev_level)
                + (1.0 - cfg.holt_beta) * self.trend[rest]
            )
            forecast = self.level + cfg.prewarm_lead_ticks * self.trend
            target_qps = np.maximum(y, forecast)
        elif cfg.autoscaler == "reactive":
            target_qps = y
        else:
            raise ValueError(f"unknown autoscaler {cfg.autoscaler!r}")
        raw = np.ceil(
            target_qps / (self.qps_per_replica * cfg.target_utilization)
        ).astype(np.int64)
        raw = np.clip(raw, self.min_replicas, self.reserved_replicas)
        up = raw >= self.target_replicas
        self.target_replicas[up] = raw[up]
        self.below_ticks[up] = 0
        self.below_ticks[~up] += 1
        fire = ~up & (self.below_ticks >= cfg.scale_down_ticks)
        self.target_replicas[fire] = raw[fire]
        self.below_ticks[fire] = 0
        return self.target_replicas


class ServingTier:
    """Simulator-side engine: owns the trace, the ``ServiceTable``, the
    serving ``Job`` rows, and the SLO / reclaim / loan accounting.

    Replicas are independent, so each service schedules as up to
    ``shards_per_service`` replica-group shard jobs (replica targets
    round-robined across them): placement never needs one huge contiguous
    gang, and a spike's growth lands wherever borrowers freed capacity.

    Protocol (both event loops):

    * ``begin_tick(now)`` — once per scheduler tick, *before* ``decide``:
      advances traffic + autoscaler and returns per-*shard* target GPUs
      (``None`` if this wall time is still inside the previous tick).  The
      simulator writes the targets into the demand columns.
    * ``end_tick(now, alloc, downtime_until, best_effort_allocated)`` —
      after the decision is applied: scores the SLO window, closes/opens
      reclaim deficits, accrues loaned GPU time.
    """

    def __init__(
        self,
        cfg: ServingConfig,
        tick_seconds: float,
        horizon_seconds: float,
        costs: CostModel,
    ):
        self.cfg = cfg
        self.tick = float(tick_seconds)
        self.trace = TrafficTrace(cfg.services, cfg.traffic, horizon_seconds)
        rho = cfg.target_utilization
        qpr = np.array([s.profile.qps_per_replica for s in cfg.services])
        reserved = np.ceil(self.trace.peak() / (qpr * rho)).astype(np.int64)
        self.table = ServiceTable(cfg.services, reserved)
        t = self.table
        # shard layout: service i owns shards[i] consecutive shard jobs,
        # each at least one replica (so no shard's demand ever hits zero)
        self.shards = np.minimum(
            max(1, cfg.shards_per_service), t.reserved_replicas
        ).astype(np.int64)
        t.min_replicas = np.maximum(t.min_replicas, self.shards)
        t.target_replicas = t.reserved_replicas.copy()
        self.shard_service = np.repeat(np.arange(t.n), self.shards)
        self.n_shards = int(self.shards.sum())
        self.reserved_gpus = t.reserved_replicas * t.gpus_per_replica
        shard_reserved = self._distribute(t.reserved_replicas)
        gpr_shard = t.gpus_per_replica[self.shard_service]
        self.jobs: List[Job] = []
        for k in range(self.n_shards):
            i = int(self.shard_service[k])
            spec = cfg.services[i]
            self.jobs.append(
                Job(
                    id=f"svc/{spec.name}/{k - int(self.shards[:i].sum())}",
                    tier=cfg.tier,
                    demand_gpus=int(shard_reserved[k] * gpr_shard[k]),
                    gpu_hours=cfg.gpu_hours,
                    arrival=0.0,
                    min_gpus=int(gpr_shard[k]),
                    checkpoint_bytes=max(1, int(spec.profile.weight_bytes)),
                    service=True,
                )
            )
        self.costs = costs
        self.target_gpus = self.reserved_gpus.copy()  # per service
        self._last_target_gpus = self.reserved_gpus.copy()
        self._rose = np.zeros(t.n, dtype=bool)
        self._last_k = -1
        self.reclaim_latencies: List[float] = []
        self.loaned_gpu_seconds = 0.0
        self.serving_gpu_seconds = 0.0
        # observability (scheduler/telemetry.py): when the simulator runs
        # with telemetry, this is its EventLog and end_tick emits LOAN /
        # RECLAIM rows (job = service index).  last_loan_out feeds the
        # per-tick metrics series.
        self.telemetry = None
        self.last_loan_out = 0.0

    def _distribute(self, replicas: np.ndarray) -> np.ndarray:
        """Round-robin per-service replica counts over their shards."""
        out = np.empty(self.n_shards, dtype=np.int64)
        pos = 0
        for i in range(self.table.n):
            s = int(self.shards[i])
            base, rem = divmod(int(replicas[i]), s)
            for k in range(s):
                out[pos + k] = base + (1 if k < rem else 0)
            pos += s
        return out

    # -- deadline -------------------------------------------------------
    def reclaim_deadline(self) -> float:
        """Worst acceptable reclaim latency, charged from the CostModel:
        one scheduler tick to notice the spike, plus preempting a typical
        64-GPU borrower, plus re-warming the largest replica payload."""
        if self.cfg.reclaim_deadline_seconds is not None:
            return float(self.cfg.reclaim_deadline_seconds)
        borrower = self.costs.preempt_seconds(default_checkpoint_bytes(64))
        warm = max(
            self.costs.restore_seconds(j.checkpoint_bytes) for j in self.jobs
        )
        return self.tick + float(borrower) + float(warm)

    # -- per-tick protocol ----------------------------------------------
    def begin_tick(self, now: float) -> Optional[np.ndarray]:
        k = int(math.floor(now / self.tick + 1e-9))
        if k <= self._last_k:
            return None
        self._last_k = k
        t0 = k * self.tick
        t = self.table
        if self.cfg.loaning:
            targets = t.retarget(self.cfg, self.trace.at(t0))
        else:
            targets = t.reserved_replicas
        gpus = targets * t.gpus_per_replica
        self._rose = gpus > self._last_target_gpus
        self._last_target_gpus = gpus.copy()
        self.target_gpus = gpus
        shard_gpus = self._distribute(targets) * t.gpus_per_replica[
            self.shard_service
        ]
        return shard_gpus

    def end_tick(
        self,
        now: float,
        shard_alloc: np.ndarray,
        shard_downtime_until: np.ndarray,
        best_effort_allocated: float,
    ) -> None:
        t = self.table
        t0 = self._last_k * self.tick
        # aggregate shards to services: warm replicas are whole replicas
        # per shard (a partial shard grant serves nothing), residual
        # warm-up is the worst shard's
        gpr = t.gpus_per_replica[self.shard_service]
        replicas = np.bincount(
            self.shard_service, weights=shard_alloc // gpr, minlength=t.n
        ).astype(np.int64)
        alloc = np.bincount(
            self.shard_service, weights=shard_alloc, minlength=t.n
        ).astype(np.int64)
        warm = np.zeros(t.n)
        np.maximum.at(
            warm,
            self.shard_service,
            np.maximum(0.0, shard_downtime_until - now),
        )
        needed = np.ceil(
            self.trace.window_peak(t0, t0 + self.tick) / t.qps_per_replica
        ).astype(np.int64)
        grace = self.cfg.warm_grace_fraction * self.tick
        ok = (replicas >= needed) & ((t.prev_replicas >= needed) | (warm <= grace))
        t.ok_windows += ok
        t.windows += 1
        t.prev_replicas = replicas.copy()
        if self.cfg.loaning:
            ev = self.telemetry
            deficit = self.target_gpus > alloc
            had_open = ~np.isnan(t.deficit_open)
            t.deficit_open[deficit & ~had_open] = t0
            closed = ~deficit & had_open
            for i in np.nonzero(closed)[0]:
                latency = now - float(t.deficit_open[i]) + float(warm[i])
                self.reclaim_latencies.append(latency)
                if ev is not None:
                    ev.append(
                        now,
                        E_RECLAIM,
                        job=int(i),
                        cause=C_SPIKE,
                        gpus=int(alloc[i]),
                        seconds=latency,
                    )
            t.deficit_open[closed] = np.nan
            # a rise satisfied in the same tick: reclaim cost = residual warm
            instant = self._rose & ~deficit & ~had_open
            for i in np.nonzero(instant)[0]:
                latency = float(warm[i])
                self.reclaim_latencies.append(latency)
                if ev is not None:
                    ev.append(
                        now,
                        E_RECLAIM,
                        job=int(i),
                        cause=C_SPIKE,
                        gpus=int(alloc[i]),
                        seconds=latency,
                    )
            loan_out = float(np.maximum(0, self.reserved_gpus - alloc).sum())
            loaned = min(loan_out, best_effort_allocated)
            self.last_loan_out = loaned
            self.loaned_gpu_seconds += loaned * self.tick
            if ev is not None and loaned > 0:
                # one aggregate row per tick: reserved serving capacity
                # currently flowing to best-effort training
                ev.append(now, E_LOAN, gpus=int(loaned), seconds=self.tick)
        self.serving_gpu_seconds += float(alloc.sum()) * self.tick

    # -- results --------------------------------------------------------
    def attainment(self) -> float:
        """Cumulative fleet SLO attainment so far (cheap; the per-tick
        metrics series samples it every tick)."""
        windows = int(self.table.windows.sum())
        return (int(self.table.ok_windows.sum()) / windows) if windows else 1.0

    def summary(self) -> Dict[str, object]:
        t = self.table
        windows = int(t.windows.sum())
        ok = int(t.ok_windows.sum())
        lats = self.reclaim_latencies
        deadline = self.reclaim_deadline()
        return {
            "serving_windows": windows,
            "serving_violations": windows - ok,
            "serving_slo_attainment": (ok / windows) if windows else 1.0,
            "serving_attainment_by_service": {
                name: (
                    float(t.ok_windows[i] / t.windows[i]) if t.windows[i] else 1.0
                )
                for i, name in enumerate(t.names)
            },
            "serving_reclaims": len(lats),
            "serving_reclaim_mean_seconds": (
                float(np.mean(lats)) if lats else 0.0
            ),
            "serving_reclaim_max_seconds": float(np.max(lats)) if lats else 0.0,
            "serving_reclaim_deadline_seconds": deadline,
            "serving_reclaims_over_deadline": int(
                sum(1 for v in lats if v > deadline)
            ),
            "serving_loaned_gpu_hours": self.loaned_gpu_seconds / 3600.0,
            "serving_gpu_hours": self.serving_gpu_seconds / 3600.0,
            "serving_reserved_gpus": int(self.reserved_gpus.sum()),
        }
