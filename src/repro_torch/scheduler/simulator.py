"""Discrete-event fleet simulator (hierarchical scheduler harness).

Mirrors Figure 1's scopes: the GLOBAL scheduler owns the fleet model and
invokes the policy; REGIONAL state is the per-cluster capacity bookkeeping;
the WORKLOAD scope is each job's elastic controller (its SLA account +
resize/preempt reactions), embodied in Job/GpuFractionAccount.

Two faithfulness properties the seed simulator lacked:

1. **Costs are charged.**  Every preemption, migration, resize and restore
   consumes downtime derived from the ``CostModel`` (checkpoint bytes /
   blob bandwidth / barrier latency — the Table 4/5 machinery).  Downtime
   is dead GPU time: the allocation is held but makes no progress, so
   utilization and JCT honestly reflect the paper's "cheap but not free"
   claim.  ``SimResult`` reports realized per-tier downtime.

2. **One decision, one event.**  ``_apply`` classifies each job transition
   into exactly one of {preempt, restore, migrate, resize} and asserts
   per-cluster capacity conservation after every decision.

3. **Unplanned failures are just preemptions** (§1, §6).  With
   ``SimConfig(failures=...)`` a ``FailureTrace`` (or a sampled
   ``FailureModel``) kills domain capacity until repair and
   force-preempts every job intersecting the failed span, rolling its
   progress back to the last durable snapshot — graceful checkpoints
   from preempt/migrate events, plus periodic Young–Daly snapshots when
   a ``CheckpointCadence`` is configured.  ``SimResult`` reports
   ``goodput_fraction``, ``lost_work_gpu_seconds``, ``restarts_by_cause``
   and per-tier ETTR.  Both event loops share the reliability machinery;
   the failure-free vectorized hot path is untouched.

The default event loop is vectorized: job progress is advanced with
numpy over an arrival-sorted active window, and SLA delivery is recorded
into the fleet-wide ``FleetSLAAccounts`` ledger in two batched calls per
tick (the simulator swaps each job's scalar account for a ledger-backed
view at construction; ``SimConfig(sla_ledger=False)`` keeps per-job
scalar accounts for benchmarking the difference).  Per-job *state* lives
in a fleet ``JobTable`` the same way: the trace is adopted into shared
numpy columns at construction (slot == job index), each ``Job`` becomes
a thin ``TableJob`` view, and the loop advances the very columns the
policy slices and ``_apply`` writes — no re-materialized arrays, no
post-decide resync loops, completions detach in batches and free their
rows.  ``SimConfig(job_table=False)`` keeps plain scalar jobs; the two
configurations are property-tested indistinguishable
(``tests/test_job_table.py``).  50k–100k-job traces run in seconds.
``SimConfig(vectorized=False)`` keeps the seed's O(jobs) per-event
Python loop for apples-to-apples throughput comparisons
(``benchmarks/sched_scale.py``).

A copy of ``repro.scheduler.simulator``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.sla import TIERS, FleetSLAAccounts, FleetSlotAccount, GpuFractionAccount
from repro_torch.scheduler.costs import CostModel, RegionTopology, defrag_worthwhile
from repro_torch.scheduler.curves import synth_curve_params
from repro_torch.scheduler.job_table import TIER_CODE, JobTable, JobView, TableJob
from repro_torch.scheduler.node_map import NodeMap, floor_gang
from repro_torch.scheduler.policy import Decision
from repro_torch.scheduler.reliability import CheckpointCadence, FailureModel, FailureTrace
from repro_torch.scheduler.serving import ServingConfig, ServingTier
from repro_torch.scheduler.telemetry import (
    C_DRAIN,
    C_FAILURE,
    C_NONE,
    C_POLICY,
    C_PREEMPT,
    C_SLOPE,
    CAUSE_CODE,
    E_ADMIT,
    E_COMPLETE,
    E_DEFRAG,
    E_FAILURE,
    E_MIGRATE,
    E_PREEMPT,
    E_RESIZE,
    E_RESTORE,
    E_SNAPSHOT,
    F_CROSS_REGION,
    FleetTelemetry,
)
from repro_torch.scheduler.types import Cluster, Fleet, Job, Region

# tier gpu_fraction lookup by JobTable tier code (same enumeration order)
_TIER_GFRAC = np.array([TIERS[t].gpu_fraction for t in TIERS], np.float64)


@dataclasses.dataclass
class SimConfig:
    tick_seconds: float = 300.0
    horizon_seconds: float = 48 * 3600.0
    # Table 5: tens of seconds per mechanism invocation.  The scalars are
    # uniform per-event charges; ``cost_model`` (when set) derives per-job
    # costs from checkpoint size / bandwidth / barrier latency instead.
    migration_cost_seconds: float = 60.0
    preemption_cost_seconds: Optional[float] = None  # default: migration/2
    restore_cost_seconds: Optional[float] = None  # default: migration/2
    resize_cost_seconds: Optional[float] = None  # default: migration/6
    cost_model: Optional[CostModel] = None
    vectorized: bool = True  # False = seed-style O(jobs)-per-event loop
    validate: bool = True  # capacity-conservation asserts per decision
    # False = keep per-job scalar GpuFractionAccounts (the earlier baseline)
    # instead of the batched FleetSLAAccounts ledger
    sla_ledger: bool = True
    # False = keep plain scalar Job objects (the earlier baseline): the
    # policy's decide path gathers per-job attributes in Python instead
    # of slicing the fleet JobTable's columns
    job_table: bool = True
    # reliability: a replayable FailureTrace (or a FailureModel, sampled
    # over this fleet/horizon at construction) injects unplanned failures;
    # a CheckpointCadence adds periodic snapshots so a failure loses only
    # the work since the last one (None = checkpoint-on-preempt-only)
    failures: Optional[Union[FailureTrace, FailureModel]] = None
    cadence: Optional[CheckpointCadence] = None
    # node-granular placement: the simulator owns a fleet NodeMap (per-node
    # free counts + per-job node spans), the policy plans gang-compatible
    # spans against it, failures pick victims from the real assignments and
    # a defragmentation pass consolidates stranded fragments.  False keeps
    # the pre-NodeMap cluster-granular behaviour.
    node_placement: bool = True
    # elastic inference serving tier (scheduler/serving.py): services become
    # guaranteed jobs whose demand an autoscaler retargets every tick from a
    # seeded traffic trace, loaning idle reserved capacity to best-effort
    # training between spikes.  None = no serving tier.
    serving: Optional[ServingConfig] = None
    # observability (scheduler/telemetry.py): True builds a FleetTelemetry
    # (structured event log + per-tick metrics + enabled profiler), or pass
    # an existing FleetTelemetry to emit into.  Strictly read-only w.r.t.
    # scheduling — decision digests are pinned identical either way.
    telemetry: Union[bool, "FleetTelemetry", None] = None

    def costs(self) -> CostModel:
        if self.cost_model is not None:
            return self.cost_model
        return CostModel.uniform(
            self.migration_cost_seconds,
            preemption_cost_seconds=self.preemption_cost_seconds,
            restore_cost_seconds=self.restore_cost_seconds,
            resize_cost_seconds=self.resize_cost_seconds,
        )


@dataclasses.dataclass
class SimResult:
    utilization: float
    sla_attainment: Dict[str, float]
    mean_jct: Dict[str, float]
    completed: int
    total_jobs: int
    preemptions: int
    migrations: int
    resizes: int
    queue_seconds: float  # total job-seconds spent fully queued
    gpu_seconds_idle: float
    restores: int = 0
    gpu_seconds_dead: float = 0.0  # allocated but making no progress
    downtime_by_tier: Dict[str, float] = dataclasses.field(default_factory=dict)
    migrations_cross_region: int = 0  # subset of migrations that moved region
    restores_cross_region: int = 0  # subset of restores that moved region
    # reliability accounting (all zero / empty without injected failures)
    failure_events: int = 0  # domain failures applied (per affected cluster)
    job_failures: int = 0  # jobs killed by a failure (forced preemptions)
    snapshots: int = 0  # cadence-driven periodic snapshots taken
    lost_work_gpu_seconds: float = 0.0  # progress destroyed by failures
    # of all GPU-seconds consumed (productive + charged-dead), the
    # fraction that produced *retained* progress: failures claw back the
    # work since the last snapshot, snapshot/restore overheads are dead
    goodput_fraction: float = 1.0
    # per-tier realized goodput: mean over a tier's arrived jobs of
    # RETAINED progress (failures claw back unsnapshotted work) relative
    # to a dedicated machine's pace — the reliability analogue of the
    # GPU-fraction SLA, ordered premium >= standard >= basic by admission
    # preference even under failure storms
    goodput_by_tier: Dict[str, float] = dataclasses.field(default_factory=dict)
    restarts_by_cause: Dict[str, int] = dataclasses.field(default_factory=dict)
    # mean seconds from a job's failure to its restart (per tier)
    ettr_by_tier: Dict[str, float] = dataclasses.field(default_factory=dict)
    # fragmentation accounting (zero without node placement): time-averaged
    # free GPUs sitting in holes too small for any queued gang's smallest
    # admissible single-node piece, and the consolidation moves made
    fragmentation_stranded_gpus: float = 0.0
    defrag_migrations: int = 0  # subset of ``migrations``
    # serving-tier accounting (all zero / empty without SimConfig.serving):
    # SLO windows are (service, tick) pairs; a window is met when enough
    # WARM replicas covered the window's peak qps.  Reclaim latency is the
    # time from a loan-reclaiming retarget to warm restored capacity,
    # measured against the CostModel-charged deadline.
    serving_windows: int = 0
    serving_violations: int = 0
    serving_slo_attainment: float = 1.0
    serving_attainment_by_service: Dict[str, float] = dataclasses.field(
        default_factory=dict
    )
    serving_reclaims: int = 0
    serving_reclaim_mean_seconds: float = 0.0
    serving_reclaim_max_seconds: float = 0.0
    serving_reclaim_deadline_seconds: float = 0.0
    serving_reclaims_over_deadline: int = 0
    serving_loaned_gpu_hours: float = 0.0
    serving_gpu_hours: float = 0.0
    serving_reserved_gpus: int = 0

    def summary(self) -> str:
        """One-screen human-readable run report.

        Multi-line: a fleet header, a per-tier table (SLA, goodput,
        mean JCT, charged downtime), the mechanism counters, and — only
        when present — failure, serving and fragmentation lines.  Used
        for ``sched_scale.py`` / ``sched_sim.py`` stdout.
        """
        lines = [
            f"fleet      util {self.utilization:.3f}"
            f" | goodput {self.goodput_fraction:.3f}"
            f" | completed {self.completed}/{self.total_jobs}"
            f" | queued {self.queue_seconds / 3600:.0f} job-h",
            "tier         sla    goodput  mean-jct  downtime",
        ]
        for t in self.sla_attainment:
            jct = self.mean_jct.get(t, float("nan"))
            lines.append(
                f"  {t:<9} {self.sla_attainment[t]:>6.3f}"
                f"  {self.goodput_by_tier.get(t, 1.0):>6.3f}"
                f"  {jct / 3600:>7.1f}h"
                f"  {self.downtime_by_tier.get(t, 0.0) / 3600:>7.1f}h"
            )
        lines.append(
            f"mechanisms preempt {self.preemptions}"
            f" | migrate {self.migrations}"
            f" (cross {self.migrations_cross_region},"
            f" defrag {self.defrag_migrations})"
            f" | resize {self.resizes}"
            f" | restore {self.restores}"
            f" | snapshots {self.snapshots}"
        )
        if self.failure_events or self.job_failures:
            restarts = ", ".join(
                f"{c} {n}" for c, n in sorted(self.restarts_by_cause.items())
            )
            ettr = ", ".join(
                f"{t} {v:.0f}s" for t, v in self.ettr_by_tier.items()
            )
            lines.append(
                f"failures   events {self.failure_events}"
                f" | jobs killed {self.job_failures}"
                f" | lost {self.lost_work_gpu_seconds / 3600:.0f} gpu-h"
                + (f" | restarts[{restarts}]" if restarts else "")
                + (f" | ettr[{ettr}]" if ettr else "")
            )
        if self.serving_windows:
            lines.append(
                f"serving    slo {self.serving_slo_attainment:.4f}"
                f" ({self.serving_violations}/{self.serving_windows}"
                " windows missed)"
                f" | reclaims {self.serving_reclaims}"
                f" (max {self.serving_reclaim_max_seconds:.0f}s"
                f" <= {self.serving_reclaim_deadline_seconds:.0f}s)"
                f" | loaned {self.serving_loaned_gpu_hours:.0f} gpu-h"
                f" | reserved {self.serving_reserved_gpus} GPUs"
            )
        if self.fragmentation_stranded_gpus or self.defrag_migrations:
            lines.append(
                "fragmentation stranded"
                f" {self.fragmentation_stranded_gpus:.1f} GPUs (time-avg)"
                f" | defrag moves {self.defrag_migrations}"
            )
        return "\n".join(lines)


def make_fleet(
    n_regions: int = 2,
    clusters_per_region: int = 2,
    gpus_per_cluster: int = 512,
    with_topology: bool = True,
    gpus_per_node: int = 8,
) -> Fleet:
    """Build a synthetic fleet; by default it carries a realistic tiered
    ``RegionTopology`` (intra-region blob bandwidth, a fast tier between
    ring-adjacent regions, a slow tier for far pairs) so migrations are
    priced by region pair.  ``with_topology=False`` keeps the seed's
    region-blind pricing for controlled experiments.  Clusters carry node
    granularity (``gpus_per_node``) so device/node/cluster/region failure
    domains are real."""
    regions = []
    for r in range(n_regions):
        clusters = [
            Cluster(
                f"r{r}c{c}", f"r{r}", gpus_per_cluster, gpus_per_node=gpus_per_node
            )
            for c in range(clusters_per_region)
        ]
        regions.append(Region(f"r{r}", clusters))
    topology = None
    if with_topology:
        topology = RegionTopology.tiered([r.id for r in regions])
    return Fleet(regions, topology=topology)


def synth_workload(
    n_jobs: int,
    fleet_gpus: int,
    seed: int = 0,
    mean_interarrival: float = 600.0,
    work_scale: float = 1.0,
    curves: bool = False,
) -> List[Job]:
    """Synthetic trace: mixed tiers/sizes, load ~ fleet capacity.

    ``work_scale`` shortens/lengthens jobs without changing the arrival
    process or size mix (used by the scale benchmark to hold fleet load
    near saturation for dense traces).

    ``curves=True`` additionally draws a concave scaling curve per job
    (``curves.synth_curve_params``: a saturation knee in [demand, 2
    demand] and a shallow post-knee slope) from a SEPARATE seeded
    stream, so the base trace — arrivals, sizes, tiers, splice floors —
    stays byte-identical to ``curves=False``.
    """
    rng = np.random.Generator(np.random.Philox(seed))
    jobs = []
    t = 0.0
    tiers = ["premium", "standard", "basic"]
    tier_p = [0.2, 0.4, 0.4]
    for i in range(n_jobs):
        t += float(rng.exponential(mean_interarrival))
        demand = int(2 ** rng.integers(3, 9))  # 8..256 GPUs
        hours = float(rng.uniform(0.5, 8.0)) * demand / 64 * work_scale
        tier = str(rng.choice(tiers, p=tier_p))
        max_splice = int(2 ** rng.integers(0, 3))  # 1,2,4 (ZeRO floor)
        jobs.append(
            Job(
                id=f"j{i}",
                tier=tier,
                demand_gpus=demand,
                gpu_hours=hours * demand,
                arrival=t,
                min_gpus=max(1, demand // max_splice),
            )
        )
    if curves and jobs:
        crng = np.random.Generator(np.random.Philox(seed ^ 0xC0FFEE))
        demands = np.fromiter((j.demand_gpus for j in jobs), np.int64, len(jobs))
        knee, sat = synth_curve_params(crng, demands)
        for j, k, s in zip(jobs, knee, sat):
            j.knee_gpus = int(k)
            j.sat_slope = float(s)
    return jobs


def _release_account(j: Job) -> None:
    """Free a completed job's ledger slot (views only; scalar accounts
    have nothing to release)."""
    if isinstance(j.account, FleetSlotAccount):
        j.account.release()


class FleetSimulator:
    def __init__(
        self,
        fleet: Fleet,
        jobs: List[Job],
        policy,
        cfg: Optional[SimConfig] = None,
    ):
        self.fleet = fleet
        self.policy = policy
        self.cfg = cfg or SimConfig()
        self.costs = self.cfg.costs()
        # region-aware pricing: a fleet that declares a topology has its
        # migrations charged by (source, destination) region pair
        if fleet.topology is not None and self.costs.topology is None:
            self.costs = dataclasses.replace(self.costs, topology=fleet.topology)
        # elastic serving tier: each service becomes a guaranteed Job
        # PREPENDED to the trace (the slot == index invariants below then
        # hold for them too) whose demand column the autoscaler retargets
        # in _serving_begin before every decide
        self.serving: Optional[ServingTier] = None
        self._svc_open = False
        jobs = list(jobs)
        if self.cfg.serving is not None:
            self.serving = ServingTier(
                self.cfg.serving,
                self.cfg.tick_seconds,
                self.cfg.horizon_seconds,
                self.costs,
            )
            jobs = self.serving.jobs + jobs
            self._svc_idx = np.arange(len(self.serving.jobs))
            self._basic_mask = np.fromiter(
                (j.tier == "basic" for j in jobs), bool, len(jobs)
            )
        self._jobs_list = jobs
        self.jobs = {j.id: j for j in jobs}
        # thread the charged cost model into the policy (unless the caller
        # configured one explicitly): the scheduler should weigh the same
        # downtime the simulator charges
        if hasattr(policy, "bind_costs"):
            policy.bind_costs(self.costs, self.cfg.tick_seconds)
        # observability: build (or adopt) the telemetry bundle.  The event
        # log and metrics are emitted from the apply / reliability /
        # serving paths below; the policy's decide-pass profiler is
        # swapped for the bundle's enabled one so its spans land in the
        # exported trace.  All of it is read-only w.r.t. decisions.
        tele = self.cfg.telemetry
        if tele is True:
            tele = FleetTelemetry()
        self.tele: Optional[FleetTelemetry] = tele if tele else None
        self._ev = self.tele.events if self.tele is not None else None
        if self.tele is not None:
            if hasattr(policy, "bind_telemetry"):
                policy.bind_telemetry(self.tele)
            if self.serving is not None:
                self.serving.telemetry = self.tele.events
        self._m_prev = {"decide": 0.0, "place": 0.0, "apply": 0.0}
        self._stranded_prev = 0.0
        # fleet-wide SLA ledger: swap each job's pristine scalar account
        # for a ledger-backed view so SLA recording and the policy's
        # headroom consultation run as batched array passes.  Jobs handed
        # in with recorded history or warm caches keep their scalar
        # account (the policy falls back per job for those).
        if self.cfg.sla_ledger:
            if fleet.sla is None:
                fleet.sla = FleetSLAAccounts()
            for j in self._jobs_list:
                acc = j.account
                if (
                    isinstance(acc, GpuFractionAccount)
                    and not acc.intervals
                    and not acc._wcache
                ):
                    j.account = FleetSlotAccount(fleet.sla, j.tier, j.demand_gpus)
        self._ledger = fleet.sla if self.cfg.sla_ledger else None
        # job-state SoA: adopt the trace into a fresh fleet JobTable so
        # the decide path reads column slices (zero per-job gathering),
        # the event loop advances the same columns _apply writes (no
        # resync loops) and completed jobs release their rows.  Slots are
        # registered in job order into a fresh table, so slot == index in
        # self._jobs_list — the vectorized loop indexes columns directly.
        # A trace containing jobs already adopted elsewhere (foreign
        # TableJobs) keeps the object path end to end.
        self._table: Optional[JobTable] = None
        if self.cfg.job_table and all(type(j) is Job for j in self._jobs_list):
            table = JobTable(
                clusters=[c.id for c in fleet.clusters()],
                sla=self._ledger,
                capacity=max(1, len(self._jobs_list)),
            )
            table.adopt_batch(self._jobs_list)
            self._table = table
            # the fleet's table handle always points at the CURRENT
            # simulator's table (a reused Fleet must not keep a stale one)
            fleet.jobs = table
        # node-granular placement: the fleet NodeMap holds per-node free
        # counts and per-job node spans (row == trace index == table
        # slot); the policy plans spans against it, _apply commits them,
        # and failures pick victims from the real node assignments
        self._cluster_idx = fleet.cluster_index()
        self.defrag_migrations = 0
        self._stranded_sum = 0.0
        self._frag_ticks = 0
        if self.cfg.node_placement:
            fleet.node_map = NodeMap.from_fleet(
                fleet, capacity_rows=max(1, len(self._jobs_list))
            )
            for i, j in enumerate(self._jobs_list):
                j.node_slot = i
        else:
            fleet.node_map = None
        self.now = 0.0
        self.preemptions = 0
        self.migrations = 0
        self.migrations_cross_region = 0
        self.resizes = 0
        self.restores = 0
        self.restores_cross_region = 0
        self.busy_gpu_seconds = 0.0
        self.gpu_seconds_dead = 0.0
        self.queue_seconds = 0.0
        self.events_processed = 0
        self._lost_by_tier = {t: 0.0 for t in TIERS}
        self._cluster_by_id = {c.id: c for c in fleet.clusters()}
        self._index = {j.id: i for i, j in enumerate(self._jobs_list)}
        # ids the current decision's water-filling pass slope-expanded
        # (refreshed by _apply; resize events on them carry cause=slope)
        self._slope_expanded: frozenset = frozenset()
        # ---- reliability: failure schedule + checkpoint cadence ----------
        self.failure_events = 0
        self.job_failures = 0
        self.snapshots = 0
        self.lost_work_gpu_seconds = 0.0
        self.restarts_by_cause: Dict[str, int] = {}
        self._ettr_sum = {t: 0.0 for t in TIERS}
        self._ettr_n = {t: 0 for t in TIERS}
        self.failure_trace: Optional[FailureTrace] = None
        # per-cluster (time, gpus, repair) failure entries + drain warnings,
        # consumed by advancing pointers; repairs are a (time, cid, amount)
        # heap where amount is the raw GPU count (cluster-granular) or the
        # failure's per-node claim list (node-granular)
        self._fails: List[Tuple[float, str, int, float, int]] = []
        self._warns: List[Tuple[float, str, float]] = []
        self._fail_ptr = 0
        self._warn_ptr = 0
        self._repairs: List[Tuple[float, str, object]] = []
        # outstanding failure amounts per cluster (unclamped sum): dead
        # capacity is min(total, outstanding), so overlapping failures
        # cannot resurrect capacity when the shorter one repairs first
        self._outstanding: Dict[str, int] = {}
        if self.cfg.failures is not None:
            trace = self.cfg.failures
            if isinstance(trace, FailureModel):
                trace = trace.sample(fleet, self.cfg.horizon_seconds)
            self.failure_trace = trace
            by_region = {r.id: [c.id for c in r.clusters] for r in fleet.regions}
            for e in trace.events:
                if e.level != "region":
                    cids = [e.domain]
                else:
                    cids = by_region.get(e.domain, [])
                for cid in cids:
                    if cid not in self._cluster_by_id:
                        continue
                    # the event KIND rides along so a telemetry FAILURE row
                    # can say what kind of failure killed the job
                    self._fails.append(
                        (e.time, cid, e.gpus, e.repair_seconds, CAUSE_CODE[e.kind])
                    )
                    if e.warning_seconds > 0:
                        self._warns.append((e.time - e.warning_seconds, cid, e.time))
            self._fails.sort()
            self._warns.sort()
        self._has_failures = bool(self._fails)
        self._reliability = self._has_failures or self.cfg.cadence is not None
        self._tau: Optional[np.ndarray] = None
        self._snap_cost: Optional[np.ndarray] = None
        if self.cfg.cadence is not None and self._jobs_list:
            clusters = fleet.clusters()
            gpn = clusters[0].gpus_per_node if clusters else 8
            self._tau = np.atleast_1d(
                np.asarray(
                    self.cfg.cadence.interval_seconds(
                        np.array([j.checkpoint_bytes for j in self._jobs_list], float),
                        np.array([j.demand_gpus for j in self._jobs_list], float),
                        gpn,
                    ),
                    np.float64,
                )
            )
            if self._table is not None:
                # per-job snapshot charge, precomputed for the masked
                # vector cadence update (same arithmetic as the scalar
                # per-job _charge path, element for element)
                n = len(self._jobs_list)
                self._snap_cost = np.broadcast_to(
                    np.asarray(
                        self.costs.snapshot_seconds(
                            self._table.checkpoint_bytes[:n].astype(np.float64)
                        ),
                        np.float64,
                    ),
                    (n,),
                ).copy()
        if self.tele is not None:
            self.tele.meta.update(
                reliability=self._reliability,
                clusters=[c.id for c in fleet.clusters()],
                tick_seconds=self.cfg.tick_seconds,
                jobs=len(self._jobs_list),
                job_ids=[j.id for j in self._jobs_list],
            )

    # -- cost charging ---------------------------------------------------------
    def _charge(self, j: Job, seconds: float) -> None:
        if seconds <= 0:
            return
        j.downtime_until = max(j.downtime_until, self.now) + seconds
        j.downtime_seconds += seconds

    # -- reliability tick (shared by both event loops) -------------------------
    def _tick_reliability(self, active: List[Job]) -> List[Job]:
        """Apply due repairs, drain warnings, failures and cadence
        snapshots at ``self.now``; returns the jobs whose runtime state
        (allocation / progress / downtime) changed so the vectorized loop
        can resync its arrays.  Operates purely on job objects — the
        legacy and vectorized loops share it verbatim."""
        changed = self._process_failures(active) if self._has_failures else []
        if self.cfg.cadence is not None:
            changed.extend(self._cadence_snapshots(active))
        return changed

    def _process_failures(self, active: List[Job]) -> List[Job]:
        now = self.now
        nm = self.fleet.node_map
        # repairs due: the domain's capacity comes back — but only down
        # to the other failures still outstanding on the same nodes
        # (per node under a NodeMap, per cluster otherwise)
        while self._repairs and self._repairs[0][0] <= now:
            _, cid, g = heapq.heappop(self._repairs)
            c = self._cluster_by_id[cid]
            if nm is not None:
                nm.repair_claims(g)
                c.dead_gpus = nm.cluster_dead(self._cluster_idx[cid])
            else:
                self._outstanding[cid] = max(0, self._outstanding.get(cid, 0) - g)
                c.dead_gpus = min(c.total_gpus, self._outstanding[cid])
        # drain warnings: the policy sees the domain as draining from here
        warns = self._warns
        while self._warn_ptr < len(warns) and warns[self._warn_ptr][0] <= now:
            _, cid, deadline = warns[self._warn_ptr]
            self._warn_ptr += 1
            c = self._cluster_by_id[cid]
            c.draining = True
            c.drain_deadline = deadline
        # failures due in (previous event, now]
        fired = []
        fails = self._fails
        while self._fail_ptr < len(fails) and fails[self._fail_ptr][0] <= now:
            fired.append(fails[self._fail_ptr])
            self._fail_ptr += 1
        if not fired:
            return []
        by_cluster: Dict[str, List[Job]] = {}
        if nm is None:
            for j in active:
                if j.done_at is None and j.allocated > 0 and j.cluster is not None:
                    by_cluster.setdefault(j.cluster, []).append(j)
        changed: List[Job] = []
        for e_time, cid, gpus, repair, ckind in fired:
            c = self._cluster_by_id[cid]
            want = c.total_gpus if gpus <= 0 else min(gpus, c.total_gpus)
            # repair is anchored to the FAILURE time, not the processing
            # tick; a sub-tick outage (already repaired) still kills its
            # victims but never marks capacity dead.  The UNCLAMPED
            # amount joins the outstanding sum so overlapping failures
            # never resurrect capacity early (dead capacity is
            # min(total, outstanding) until each failure's own repair).
            if nm is not None:
                # node-granular: the failure claims specific nodes, dead
                # capacity and victims both come from the real node
                # assignments — a job dies iff it holds a piece of a
                # node the claim actually takes capacity from
                k = self._cluster_idx[cid]
                claims = nm.fail_claims(k, want) if want > 0 else []
                vrows = nm.apply_claims(claims)
                if e_time + repair > now and want > 0:
                    heapq.heappush(self._repairs, (e_time + repair, cid, claims))
                else:
                    # sub-tick outage: victims died, capacity is back
                    nm.repair_claims(claims)
                c.dead_gpus = nm.cluster_dead(k)
                victims = [self._jobs_list[r] for r in vrows]
            else:
                if e_time + repair > now and want > 0:
                    self._outstanding[cid] = self._outstanding.get(cid, 0) + want
                    c.dead_gpus = min(c.total_gpus, self._outstanding[cid])
                    heapq.heappush(self._repairs, (e_time + repair, cid, want))
                # victims without a NodeMap fall back to the packing-order
                # approximation: jobs pack the cluster in (arrival, id)
                # order; a partial failure of W GPUs takes out every job
                # overlapping the first W.
                pool = sorted(
                    by_cluster.get(cid, []), key=lambda j: (j.arrival, j.id)
                )
                if want >= c.total_gpus:
                    victims = list(pool)
                else:
                    victims, cum = [], 0
                    for j in pool:
                        if cum >= want:
                            break
                        victims.append(j)
                        cum += j.allocated
                if victims:
                    vset = set(id(v) for v in victims)
                    by_cluster[cid] = [j for j in pool if id(j) not in vset]
            if c.draining and e_time >= c.drain_deadline - 1e-9:
                # the warned drain itself fired: dead capacity takes over.
                # An unrelated failure inside the warning window must NOT
                # cancel the drain — evacuation continues to the deadline.
                c.draining = False
            self.failure_events += 1
            for j in victims:
                lost = max(0.0, j.progress - j.snap_progress)
                lost_gpu_seconds = lost * j.gpu_hours * 3600.0
                self.lost_work_gpu_seconds += lost_gpu_seconds
                self._lost_by_tier[j.tier] += lost_gpu_seconds
                if self._ev is not None:
                    self._ev.append(
                        now,
                        E_FAILURE,
                        job=self._index[j.id],
                        cluster=self._cluster_idx.get(j.cluster, -1),
                        tier=TIER_CODE[j.tier],
                        cause=ckind,
                        gpus=j.allocated,
                        seconds=lost_gpu_seconds,
                    )
                j.progress = j.snap_progress
                j.allocated = 0
                j.failures += 1
                j.failed_at = now
                j.queued_since = now  # fairness aging restarts here
                self.job_failures += 1
                changed.append(j)
        return changed

    def _cadence_snapshots(self, active: List[Job]) -> List[Job]:
        """Periodic snapshots per the Young–Daly cadence: running jobs
        past their interval checkpoint now, paying the snapshot's
        downtime in exchange for bounding the work a failure can claw
        back.  ``Job.progress`` must be current (the vectorized loop
        syncs it before calling)."""
        if self._tau is None:
            return []
        now = self.now
        changed: List[Job] = []
        for j in active:
            if j.done_at is not None or j.allocated <= 0:
                continue
            i = self._index[j.id]
            if now - j.snap_time < self._tau[i] - 1e-9:
                continue
            j.snap_progress = j.progress
            j.snap_time = now
            cost = self.costs.snapshot_seconds(j.checkpoint_bytes)
            self._charge(j, cost)
            self.snapshots += 1
            if self._ev is not None:
                self._ev.append(
                    now,
                    E_SNAPSHOT,
                    job=i,
                    cluster=self._cluster_idx.get(j.cluster, -1),
                    tier=TIER_CODE[j.tier],
                    gpus=j.allocated,
                    seconds=cost,
                )
            changed.append(j)
        return changed

    def _cadence_snapshots_vec(self, act: np.ndarray) -> None:
        """The scalar ``_cadence_snapshots`` sweep as one masked update
        over the JobTable's columns: same due rule, same charge
        arithmetic (zero-cost snapshots skip the downtime write exactly
        like ``_charge``), snapshot-for-snapshot identical —
        ``tests/test_reliability.py`` pins the equivalence."""
        if self._tau is None or act.size == 0:
            return
        now = self.now
        t = self._table
        run = act[t.allocated[act] > 0]
        due = run[now - t.snap_time[run] >= self._tau[run] - 1e-9]
        if due.size == 0:
            return
        t.snap_progress[due] = t.progress[due]
        t.snap_time[due] = now
        cost = self._snap_cost[due]
        pos = cost > 0
        if pos.any():
            dp = due[pos]
            t.downtime_until[dp] = np.maximum(t.downtime_until[dp], now) + cost[pos]
            t.downtime_seconds[dp] += cost[pos]
        self.snapshots += int(due.size)
        if self._ev is not None:
            # batched append — one row per due job, identical to the
            # scalar sweep's per-job appends (zero-cost snapshots emit a
            # 0.0-second row exactly like _charge's no-op)
            self._ev.append_batch(
                now,
                E_SNAPSHOT,
                job=due,
                cluster=t.cluster_idx[due],
                tier=t.tier_code[due],
                gpus=t.allocated[due],
                seconds=cost,
            )

    # -- decision application (shared by both event loops) ---------------------
    def _apply(self, decision: Decision) -> None:
        """Apply one scheduling decision, classifying each job transition
        into exactly ONE event and charging its cost model downtime.

        Decisions carrying our JobTable's array form take the masked
        fast path: only jobs with an actual event (preempt / charged
        restore / migrate / resize — a small subset of the fleet) go
        through the per-job classifier; everyone else is updated with a
        few column writes.  Foreign or hand-built decisions walk the
        mapping per job as before."""
        tu = decision.table_update
        # resize events on these jobs this tick were granted by the
        # curve-priced water-filling pass; tag their cause accordingly
        self._slope_expanded = (
            frozenset(decision.slope_expanded)
            if decision.slope_expanded
            else frozenset()
        )
        fast = tu is not None and self._table is not None and tu[0] is self._table
        if fast:
            self._apply_table(tu[1], tu[2], tu[3])
        else:
            for jid, (gpus, cluster) in decision.alloc.items():
                self._apply_one(self.jobs[jid], gpus, cluster)
        for jid in decision.preemptions:
            # victims the policy listed without a zeroed alloc entry
            j = self.jobs[jid]
            if j.done_at is None and j.allocated > 0:
                j.preemptions += 1
                self.preemptions += 1
                j.restore_debt += self.costs.preempt_seconds(j.checkpoint_bytes)
                if self._ev is not None:
                    self._ev.append(
                        self.now,
                        E_PREEMPT,
                        job=self._index[j.id],
                        cluster=self._cluster_idx.get(j.cluster, -1),
                        tier=TIER_CODE[j.tier],
                        cause=C_POLICY,
                        gpus=j.allocated,
                    )
                j.allocated = 0
                j.queued_since = self.now
                if self._reliability:
                    j.snap_progress = j.progress
                    j.snap_time = self.now
        self._commit_node_plan(decision)
        if self.cfg.validate and not fast:
            self._check_capacity(decision)
        if self.cfg.validate:
            self._check_nodes()

    def _commit_node_plan(self, decision: Decision) -> None:
        """Write the decision's node spans into the NodeMap.  Policies
        that planned placement hand over (node map, released rows,
        assigned pieces) — committed verbatim, releases first, so spans
        are exactly what the decide pass saw.  Planless decisions (the
        static gang baseline, hand-written policies) are resynced with a
        greedy auto-fit per changed job; its per-node conservation
        assert rejects over-allocating policies below cluster
        granularity too."""
        nm = self.fleet.node_map
        if nm is None:
            return
        plan = decision.node_plan
        if plan is not None and plan[0] is nm:
            _, released, assigns = plan
            nm.release_many(np.asarray(released, np.int64))
            nm.assign_many(assigns)
            return
        for jid, (g, cid) in decision.alloc.items():
            j = self.jobs[jid]
            if j.done_at is not None:
                continue
            row = j.node_slot
            if row < 0:
                continue
            g = int(g)
            k = self._cluster_idx.get(cid, -1) if cid is not None else -1
            if nm.span_total(row) == g and (g == 0 or nm.span_cluster(row) == k):
                continue
            nm.release(row)
            if g > 0:
                assert k >= 0, f"{jid}: allocated without a cluster"
                nm.auto_fit(row, k, g)
        for jid in decision.preemptions:
            j = self.jobs[jid]
            if j.done_at is None and j.allocated == 0:
                nm.release(j.node_slot)

    def _check_nodes(self) -> None:
        """Per-node conservation, asserted every tick in both event
        loops: free + used + dead == cap on every node, the span pool
        agrees with the per-node used counts, and each live job's span
        sums to exactly its allocation (no span without an allocation,
        no allocation without a span)."""
        nm = self.fleet.node_map
        if nm is None:
            return
        nm.check()
        rows = nm.live_rows()
        n = len(self._jobs_list)
        assert rows.size == 0 or int(rows.max()) < n, "span row out of range"
        if self._table is not None:
            alloc = self._table.allocated[:n]
        else:
            alloc = np.fromiter(
                (
                    0 if j.done_at is not None else j.allocated
                    for j in self._jobs_list
                ),
                np.int64,
                n,
            )
        held = np.zeros(n, np.int64)
        held[rows] = nm.row_total[rows]
        bad = np.flatnonzero(held != alloc)
        assert bad.size == 0, (
            f"job {self._jobs_list[bad[0]].id}: node span holds "
            f"{held[bad[0]]} GPUs but allocation is {alloc[bad[0]]}"
        )

    # -- fragmentation + defragmentation ---------------------------------------
    def _frag_defrag_tick(self, active) -> None:
        """Post-decision fragmentation accounting and (at most) one
        defragmentation move: free GPUs in holes smaller than any queued
        gang's smallest admissible single-node piece are *stranded*;
        when emptying one full node would turn a shape-infeasible queued
        floor feasible and the freed capacity is worth the charged
        migration downtime, consolidate that node's pieces into best-fit
        holes elsewhere in the cluster."""
        nm = self.fleet.node_map
        if nm is None:
            return
        if isinstance(active, JobView):
            t = self._table
            slots = active.slots
            qs = slots[t.allocated[slots] == 0]
            shapes = {
                (int(d), int(m))
                for d, m in zip(t.demand_gpus[qs], t.min_gpus[qs])
            }
        else:
            shapes = {
                (j.demand_gpus, j.min_gpus)
                for j in active
                if j.done_at is None and j.allocated == 0
            }
        self._stranded_sum += nm.stranded_gpus(sorted(shapes))
        self._frag_ticks += 1
        if not shapes or getattr(self.policy, "name", "") == "static":
            return  # static never migrates; nothing queued = nothing stranded
        floors = sorted(
            {f for f in (floor_gang(d, m) for d, m in shapes) if f > 0}
        )
        if floors:
            self._maybe_defrag(nm, floors)

    def _maybe_defrag(self, nm: NodeMap, floors: List[int]) -> None:
        ov = nm.overlay()
        for k in range(nm.n_clusters):
            gpn = int(nm.cluster_gpn[k])
            for f in floors:
                w, r = divmod(f, gpn)
                if int(ov.cfree[k]) < f or ov.feasible(k, f):
                    continue  # hopeless or already feasible as-is
                empty, maxp = ov._stats(k)
                if not (empty + 1 >= w and (r == 0 or maxp >= r or empty + 1 >= w + 1)):
                    continue  # one consolidated node would not unblock it
                if self._defrag_cluster(nm, k):
                    return  # at most one consolidation per tick
                break  # no movable node here; try the next cluster

    def _defrag_cluster(self, nm: NodeMap, k: int) -> bool:
        """Empty one full-capacity node of cluster ``k`` into best-fit
        holes on other occupied nodes, gated by ``defrag_worthwhile``.
        Each moved job is charged exactly one intra-region migration."""
        lo, hi = int(nm.cluster_lo[k]), int(nm.cluster_hi[k])
        gpn = int(nm.cluster_gpn[k])
        cap = nm.node_cap[lo:hi]
        used = nm.node_used[lo:hi]
        free = nm.node_free[lo:hi]
        dead = np.minimum(cap, nm.node_out[lo:hi])
        src = np.flatnonzero((cap == gpn) & (dead == 0) & (used > 0) & (free > 0))
        src = src[np.lexsort((src, used[src]))]  # cheapest to empty first
        idx = np.arange(cap.size)
        for a in src:
            need = int(used[a])
            tgt = np.flatnonzero((free >= need) & (used > 0) & (idx != a))
            if not tgt.size:
                continue
            b = lo + int(tgt[np.lexsort((tgt, free[tgt]))[0]])  # best fit
            rows = nm.rows_on_node(lo + int(a))
            movers = [self._jobs_list[int(r)] for r in rows]
            if not defrag_worthwhile(
                self.costs,
                [j.checkpoint_bytes for j in movers],
                gpn,
                self.cfg.tick_seconds,
            ):
                continue
            for row, j in zip(rows, movers):
                nm.move_piece(int(row), lo + int(a), b)
                j.migrations += 1
                self.migrations += 1
                self.defrag_migrations += 1
                charged = self.costs.migrate_seconds(j.checkpoint_bytes)
                self._charge(j, charged)
                if self._reliability:
                    # the migration round trip checkpoints state
                    j.snap_progress = j.progress
                    j.snap_time = self.now
                if self._ev is not None:
                    self._ev.append(
                        self.now,
                        E_DEFRAG,
                        job=self._index[j.id],
                        cluster=self._cluster_idx.get(j.cluster, -1),
                        tier=TIER_CODE[j.tier],
                        gpus=j.allocated,
                        seconds=charged,
                    )
            return True
        return False

    def _apply_table(
        self, slots: np.ndarray, gpus: np.ndarray, placed: np.ndarray
    ) -> None:
        """Masked-column form of the per-job apply loop.  Event
        classification uses the same predicates as ``_apply_one``'s
        branch chain (cluster codes index ``fleet.clusters()``, which
        ``Decision.table_update`` guarantees); classified jobs run the
        identical scalar body, so charges and counters cannot drift."""
        t = self._table
        alive = np.isnan(t.done_at[slots])
        if not alive.all():
            slots, gpus, placed = slots[alive], gpus[alive], placed[alive]
        prev = t.allocated[slots]
        prev_c = t.cluster_idx[slots]
        run_on = (prev > 0) & (gpus > 0)
        event = (
            ((prev > 0) & (gpus == 0))  # preemption
            | ((prev == 0) & (gpus > 0) & t.ever_ran[slots])  # charged restore
            | (run_on & (placed >= 0) & (prev_c >= 0) & (placed != prev_c))
            | (run_on & (gpus != prev))  # migrate / resize
        )
        eidx = np.flatnonzero(event)
        if eidx.size:
            clusters = self.fleet.clusters()
            objs = t.objs
            for i in eidx:
                cid = clusters[placed[i]].id if placed[i] >= 0 else None
                self._apply_one(objs[slots[i]], int(gpus[i]), cid)
        rest = np.flatnonzero(~event)
        rs = slots[rest]
        g = gpus[rest]
        t.allocated[rs] = g
        t.ever_ran[rs] |= g > 0
        pl = placed[rest]
        hasc = pl >= 0
        t.cluster_idx[rs[hasc]] = pl[hasc]
        if self._ev is not None:
            # the only lifecycle transition left in the bulk path is the
            # free first admission (prev 0 -> g without a checkpoint);
            # everything else was classified through _apply_one above
            adm = np.flatnonzero((prev[rest] == 0) & (g > 0))
            if adm.size:
                ra = rs[adm]
                self._ev.append_batch(
                    self.now,
                    E_ADMIT,
                    job=ra,
                    cluster=t.cluster_idx[ra],
                    tier=t.tier_code[ra],
                    gpus=g[adm],
                )
        if self.cfg.validate:
            self._check_capacity_table(slots, gpus, placed)

    def _apply_one(self, j: Job, gpus: int, cluster: Optional[str]) -> None:
        if j.done_at is not None:
            return
        prev_g = j.allocated
        if prev_g > 0 and gpus == 0:
            # preemption: quiesce + dump + upload.  Work-conserving —
            # the cost is carried as debt and delays the next restore.
            # The graceful checkpoint is a durable snapshot: a later
            # failure can only claw back work past this point.
            j.preemptions += 1
            self.preemptions += 1
            j.restore_debt += self.costs.preempt_seconds(j.checkpoint_bytes)
            j.queued_since = self.now  # fairness aging restarts here
            if self._reliability:
                j.snap_progress = j.progress
                j.snap_time = self.now
            if self._ev is not None:
                self._ev.append(
                    self.now,
                    E_PREEMPT,
                    job=self._index[j.id],
                    cluster=self._cluster_idx.get(j.cluster, -1),
                    tier=TIER_CODE[j.tier],
                    cause=C_POLICY,
                    gpus=prev_g,
                )
        elif prev_g == 0 and gpus > 0:
            # (re)start.  First admission is free; a restore pays
            # download + rendezvous + the carried preempt debt.  A
            # restore onto a different cluster is still one restore —
            # but its download leg is priced by the (checkpoint
            # region, destination region) pair, like a migration's.
            if j.ever_ran:
                self.restores += 1
                src = self.fleet.region_of(j.cluster)
                dst = self.fleet.region_of(cluster) if cluster is not None else src
                cross = src is not None and dst is not None and src != dst
                if cross:
                    self.restores_cross_region += 1
                charged = j.restore_debt + self.costs.restore_seconds(
                    j.checkpoint_bytes, src, dst
                )
                self._charge(j, charged)
                j.restore_debt = 0.0
                if j.failed_at is not None:
                    # restart after an unplanned failure: ETTR sample
                    cause = "failure"
                    self._ettr_sum[j.tier] += self.now - j.failed_at
                    self._ettr_n[j.tier] += 1
                    j.failed_at = None
                else:
                    cause = "preempt"
                if self._reliability:
                    self.restarts_by_cause[cause] = (
                        self.restarts_by_cause.get(cause, 0) + 1
                    )
                if self._ev is not None:
                    dcid = cluster if cluster is not None else j.cluster
                    self._ev.append(
                        self.now,
                        E_RESTORE,
                        job=self._index[j.id],
                        cluster=self._cluster_idx.get(dcid, -1),
                        tier=TIER_CODE[j.tier],
                        cause=C_FAILURE if cause == "failure" else C_PREEMPT,
                        gpus=gpus,
                        seconds=charged,
                        flags=F_CROSS_REGION if cross else 0,
                    )
            elif self._ev is not None:
                dcid = cluster if cluster is not None else j.cluster
                self._ev.append(
                    self.now,
                    E_ADMIT,
                    job=self._index[j.id],
                    cluster=self._cluster_idx.get(dcid, -1),
                    tier=TIER_CODE[j.tier],
                    gpus=gpus,
                )
        elif (
            gpus > 0
            and cluster is not None
            and j.cluster is not None
            and cluster != j.cluster
        ):
            # live migration (possibly with a simultaneous resize —
            # still one event, one Table-5 round trip); the transfer
            # leg is priced by the (source, destination) region pair.
            # The round trip checkpoints state: snapshot refreshes.
            j.migrations += 1
            self.migrations += 1
            src = self.fleet.region_of(j.cluster)
            dst = self.fleet.region_of(cluster)
            cross = src is not None and dst is not None and src != dst
            if cross:
                self.migrations_cross_region += 1
            charged = self.costs.migrate_seconds(j.checkpoint_bytes, src, dst)
            self._charge(j, charged)
            if self._reliability:
                j.snap_progress = j.progress
                j.snap_time = self.now
            if self._ev is not None:
                # a migration off a draining cluster is a drain
                # evacuation — that's the cause the event log records
                drain = self._cluster_by_id[j.cluster].draining
                self._ev.append(
                    self.now,
                    E_MIGRATE,
                    job=self._index[j.id],
                    cluster=self._cluster_idx.get(cluster, -1),
                    tier=TIER_CODE[j.tier],
                    cause=C_DRAIN if drain else C_POLICY,
                    gpus=gpus,
                    seconds=charged,
                    flags=F_CROSS_REGION if cross else 0,
                )
        elif gpus > 0 and gpus != prev_g:
            # in-place transparent resize (splice swap)
            j.resizes += 1
            self.resizes += 1
            charged = self.costs.resize_seconds(j.checkpoint_bytes)
            self._charge(j, charged)
            if self._ev is not None:
                self._ev.append(
                    self.now,
                    E_RESIZE,
                    job=self._index[j.id],
                    cluster=self._cluster_idx.get(j.cluster, -1),
                    tier=TIER_CODE[j.tier],
                    cause=(
                        C_SLOPE if j.id in self._slope_expanded else C_NONE
                    ),
                    gpus=gpus,
                    seconds=charged,
                )
        j.allocated = gpus
        if gpus > 0:
            j.ever_ran = True
        if cluster is not None:
            j.cluster = cluster

    def _check_capacity(self, decision: Decision) -> None:
        """Fleet-capacity conservation: no decision may over-allocate any
        cluster or the fleet — counting only HEALTHY capacity, so a
        failed-out domain's GPUs cannot be handed out while it awaits
        repair."""
        used: Dict[str, int] = {}
        total = 0
        for jid, (g, c) in decision.alloc.items():
            if g <= 0 or self.jobs[jid].done_at is not None:
                continue
            total += g
            if c is not None:
                used[c] = used.get(c, 0) + g
        cap = self.fleet.capacity()
        assert total <= cap, f"fleet over-allocated: {total} > {cap}"
        for c, u in used.items():
            healthy = self._cluster_by_id[c].capacity()
            assert u <= healthy, f"cluster {c} over-allocated: {u} > {healthy}"

    def _check_capacity_table(
        self, slots: np.ndarray, gpus: np.ndarray, placed: np.ndarray
    ) -> None:
        """``_check_capacity`` over the decision's array form: one
        bincount instead of a per-job dict walk (done jobs were already
        filtered by ``_apply_table``)."""
        live = gpus > 0
        total = int(gpus[live].sum())
        cap = self.fleet.capacity()
        assert total <= cap, f"fleet over-allocated: {total} > {cap}"
        pl = placed[live]
        hasc = pl >= 0
        if not hasc.any():
            return
        clusters = self.fleet.clusters()
        used = np.bincount(pl[hasc], weights=gpus[live][hasc], minlength=len(clusters))
        healthy = np.fromiter((c.capacity() for c in clusters), np.int64, len(clusters))
        over = np.flatnonzero(used > healthy)
        assert over.size == 0, (
            f"cluster {clusters[over[0]].id} over-allocated: "
            f"{used[over[0]]:.0f} > {healthy[over[0]]}"
        )

    # ==================== legacy (seed) event loop ============================
    # O(jobs) Python scan per event; kept as the measured baseline for
    # benchmarks/sched_scale.py and as an oracle for the vectorized loop.

    def _advance_legacy(self, dt: float) -> None:
        if dt <= 0:
            return
        end = self.now + dt
        for j in self.jobs.values():
            if j.done_at is not None or j.arrival > self.now:
                continue
            # downtime split: dead GPU time delivers no SLA credit
            cut = min(max(j.downtime_until, self.now), end)
            j.account.record(self.now, cut, 0)
            j.account.record(cut, end, j.allocated)
            if j.allocated > 0:
                eff = end - cut
                self.busy_gpu_seconds += j.allocated * eff
                self.gpu_seconds_dead += j.allocated * (cut - self.now)
                if eff > 0:
                    j.progress = min(1.0, j.progress + j.rate() * eff)
                    if j.progress >= 1.0 - 1e-12:
                        if self._ev is not None:
                            self._ev.append(
                                end,
                                E_COMPLETE,
                                job=self._index[j.id],
                                cluster=self._cluster_idx.get(j.cluster, -1),
                                tier=TIER_CODE[j.tier],
                                gpus=j.allocated,
                            )
                        j.done_at = end
                        j.allocated = 0
                        _release_account(j)
                        if self.fleet.node_map is not None:
                            self.fleet.node_map.release(j.node_slot)
                        if isinstance(j, TableJob):
                            j._table.detach(j)
            else:
                self.queue_seconds += dt
        self.now = end

    # ==================== serving tier hooks ==================================

    def _serving_begin(self, now: float) -> None:
        """Once per scheduler tick, before decide: retarget each service's
        demand column from the traffic trace + autoscaler.  Both policy
        paths then see identical inputs, so decision digests stay
        equivalent with services in the mix."""
        targets = self.serving.begin_tick(now)
        self._svc_open = targets is not None
        if targets is None:
            return
        idx = self._svc_idx
        if self._table is not None:
            self._table.demand_gpus[idx] = targets
        else:
            for k in range(idx.size):
                self._jobs_list[k].demand_gpus = int(targets[k])
            demand = getattr(self, "_demand", None)
            if demand is not None:
                demand[idx] = targets.astype(demand.dtype)

    def _serving_end(self, now: float) -> None:
        """After the tick's decision is applied: score the SLO window,
        close reclaim deficits, accrue loaned GPU time."""
        self._svc_open = False
        idx = self._svc_idx
        n = len(self._jobs_list)
        if self._table is not None:
            col = self._table.allocated
            dtu = self._table.downtime_until[idx].astype(np.float64)
        else:
            col = getattr(self, "_alloc", None)
            if col is not None:
                dtu = self._downtime_until[idx].astype(np.float64)
        if col is not None:
            alloc = col[idx].astype(np.int64)
            basic = float(col[:n][self._basic_mask].sum())
        else:  # legacy loop over plain Job objects
            alloc = np.fromiter(
                (self._jobs_list[k].allocated for k in range(idx.size)),
                np.int64,
                idx.size,
            )
            dtu = np.fromiter(
                (self._jobs_list[k].downtime_until for k in range(idx.size)),
                np.float64,
                idx.size,
            )
            basic = float(
                sum(
                    j.allocated
                    for j, b in zip(self._jobs_list, self._basic_mask)
                    if b
                )
            )
        self.serving.end_tick(now, alloc, dtu, basic)

    # ==================== per-tick telemetry ==================================

    def _record_tick_metrics(self, now: float) -> None:
        """One MetricsSeries row per scheduler tick (telemetry only;
        computed OUTSIDE the decide path so the decide-time overhead gate
        measures the profiler alone)."""
        tele = self.tele
        n = len(self._jobs_list)
        nt = len(TIER_CODE)
        if self._table is not None:
            tb = self._table
            alloc = tb.allocated[:n]
            live = np.isnan(tb.done_at[:n]) & (tb.arrival[:n] <= now)
            total_alloc = int(alloc[live].sum())
            queued = live & (alloc == 0)
            counts = np.bincount(tb.tier_code[:n][queued], minlength=nt)
        else:
            counts = np.zeros(nt, np.int64)
            total_alloc = 0
            for j in self._jobs_list:
                if j.done_at is not None or j.arrival > now:
                    continue
                if j.allocated > 0:
                    total_alloc += j.allocated
                else:
                    counts[TIER_CODE[j.tier]] += 1
        cap = self.fleet.capacity()
        consumed = self.busy_gpu_seconds + self.gpu_seconds_dead
        goodput = (
            max(0.0, self.busy_gpu_seconds - self.lost_work_gpu_seconds)
            / consumed
            if consumed > 0
            else 1.0
        )
        slo, loaned = 1.0, 0.0
        if self.serving is not None:
            slo = self.serving.attainment()
            loaned = float(self.serving.last_loan_out)
        stranded = self._stranded_sum - self._stranded_prev
        self._stranded_prev = self._stranded_sum
        prof, prev = tele.prof, self._m_prev
        dec = prof.total("decide")
        plc = prof.total("place")
        app = prof.total("apply")
        tele.metrics.record(
            time=now,
            allocated_gpus=float(total_alloc),
            utilization=total_alloc / cap if cap else 0.0,
            queue_premium=float(counts[TIER_CODE["premium"]]),
            queue_standard=float(counts[TIER_CODE["standard"]]),
            queue_basic=float(counts[TIER_CODE["basic"]]),
            stranded_gpus=stranded,
            loaned_gpus=loaned,
            goodput=goodput,
            slo_attainment=slo,
            decide_seconds=dec - prev["decide"],
            place_seconds=plc - prev["place"],
            apply_seconds=app - prev["apply"],
        )
        prev["decide"], prev["place"], prev["apply"] = dec, plc, app

    def _run_legacy_loop(self) -> None:
        cfg = self.cfg
        events = [j.arrival for j in self.jobs.values()]
        t = 0.0
        while t < cfg.horizon_seconds:
            events.append(t)
            t += cfg.tick_seconds
        for t in sorted(set(events)):
            if t > cfg.horizon_seconds:
                break
            self._advance_legacy(t - self.now)
            self.events_processed += 1
            if all(j.done_at is not None for j in self.jobs.values()):
                break
            # only arrived jobs are visible to the policy (StaticGangPolicy
            # does not filter by arrival itself; the vectorized loop only
            # ever activates arrived jobs, and the two must agree)
            arrived = [j for j in self.jobs.values() if j.arrival <= self.now]
            if self._reliability:
                self._tick_reliability([j for j in arrived if j.done_at is None])
            if self.serving is not None:
                self._serving_begin(self.now)
            if self.tele is not None:
                self.tele.prof.set_anchor(self.now)
            decision = self.policy.decide(self.now, arrived, self.fleet)
            if self.tele is not None:
                with self.tele.prof.span("apply"):
                    self._apply(decision)
            else:
                self._apply(decision)
            self._frag_defrag_tick(arrived)
            if self.serving is not None and self._svc_open:
                self._serving_end(self.now)
            if self.tele is not None:
                self._record_tick_metrics(self.now)

    # ==================== vectorized event loop ===============================

    def _build_arrays(self) -> None:
        jobs = self._jobs_list
        n = len(jobs)
        if self._table is not None:
            # the JobTable IS the storage (slot == index): the loop
            # advances the very columns the policy slices and _apply's
            # property writes land in, so nothing is re-materialized
            # from the job objects and nothing needs resyncing.
            t = self._table
            t.pinned = True  # growth would decouple the bound views
            self._arrival = t.arrival
            self._demand = t.demand_gpus
            self._ideal = t.ideal
            self._ovh = t.splice_overhead
            self._knee = t.knee_gpus
            self._sat = t.sat_slope
            self._guar = _TIER_GFRAC[t.tier_code[:n]] > 0
            self._progress = t.progress
            self._alloc = t.allocated
            self._downtime_until = t.downtime_until
        else:
            self._arrival = np.array([j.arrival for j in jobs])
            self._demand = np.array([float(j.demand_gpus) for j in jobs])
            self._ideal = np.array([j.ideal_seconds for j in jobs])
            self._ovh = np.array([j.splice_overhead for j in jobs])
            self._knee = np.array([j.knee_gpus for j in jobs], np.int64)
            self._sat = np.array([j.sat_slope for j in jobs])
            self._guar = np.array([TIERS[j.tier].gpu_fraction > 0 for j in jobs])
            self._progress = np.zeros(n)
            self._alloc = np.zeros(n)
            self._downtime_until = np.zeros(n)
        self._done = np.zeros(n, dtype=bool)
        # ledger plumbing: which jobs carry a view on OUR ledger (others
        # — foreign views or history-carrying scalar accounts — record
        # through the per-job fallback), and their lazily-filled slots
        self._views = [j.account for j in jobs]
        if self._ledger is not None:
            self._is_view = np.fromiter(
                (
                    isinstance(a, FleetSlotAccount) and a.ledger is self._ledger
                    for a in self._views
                ),
                bool,
                n,
            )
        else:
            self._is_view = np.zeros(n, dtype=bool)
        self._slot = np.full(n, -1, np.int64)
        # precomputed arrival-sorted activation order (fancy indexing
        # copies, so later slot resets cannot disturb activation)
        self._arr_order = np.argsort(self._arrival[:n], kind="stable")
        self._arr_sorted = self._arrival[self._arr_order]

    def _advance_vec(self, act: np.ndarray, dt: float) -> None:
        """Numpy-batched progress update over the active window."""
        if dt <= 0 or act.size == 0:
            return
        t0, t1 = self.now, self.now + dt
        alloc = self._alloc[act]
        running = alloc > 0
        cut = np.clip(self._downtime_until[act], t0, t1)
        eff = t1 - cut  # productive seconds
        dead = cut - t0  # charged-downtime seconds
        share = np.minimum(alloc / self._demand[act], 2.0)
        # concave scaling curves (curves.scaling_eff, vector form): past
        # a job's saturation knee the marginal GPU only buys sat_slope
        # of a linear one; knee == 0 is the flat sentinel (seed model)
        k = self._knee[act]
        gf = np.minimum(alloc, 2.0 * self._demand[act])
        over = (k > 0) & (gf > k)
        if over.any():
            d = self._demand[act]
            share = np.where(
                over,
                np.minimum((k + self._sat[act] * (gf - k)) / d, 2.0),
                share,
            )
        share = np.where(
            alloc < self._demand[act], share * (1.0 - self._ovh[act]), share
        )
        dp = np.where(running, share / self._ideal[act] * eff, 0.0)
        prog = self._progress[act] + dp
        self._progress[act] = np.minimum(prog, 1.0)
        self.busy_gpu_seconds += float(np.sum(alloc * eff * running))
        self.gpu_seconds_dead += float(np.sum(alloc * dead * running))
        self.queue_seconds += float(np.count_nonzero(~running)) * dt
        # SLA delivery: only guaranteed tiers are ever consulted by the
        # policy.  Ledger-backed jobs record in two batched calls (the
        # downtime/productive split); stragglers take the per-job path.
        jobs = self._jobs_list
        gsel = np.flatnonzero(self._guar[act])
        if gsel.size:
            vmask = self._is_view[act[gsel]]
            vsel = gsel[vmask]
            if vsel.size:
                rows = act[vsel]
                slots = self._slot[rows]
                if (slots < 0).any():
                    for i in rows[slots < 0]:
                        self._slot[i] = self._views[i].ensure_slot()
                    slots = self._slot[rows]
                m = rows.size
                self._ledger.record_batch(
                    slots, np.full(m, t0), cut[vsel], np.zeros(m, np.int64)
                )
                self._ledger.record_batch(
                    slots, cut[vsel], np.full(m, t1), alloc[vsel].astype(np.int64)
                )
            for k in gsel[~vmask]:
                i = act[k]
                j = jobs[i]
                c = cut[k]
                j.account.record(t0, c, 0)
                j.account.record(c, t1, int(alloc[k]))
        # completions (done_at granularity = this advance's end, matching
        # the legacy loop's semantics)
        done_now = act[(prog >= 1.0 - 1e-12) & running]
        if done_now.size:
            if self._ev is not None:
                if self._table is not None:
                    cl = self._table.cluster_idx[done_now]
                    tc = self._table.tier_code[done_now]
                else:
                    cl = np.fromiter(
                        (
                            self._cluster_idx.get(jobs[i].cluster, -1)
                            for i in done_now
                        ),
                        np.int64,
                        done_now.size,
                    )
                    tc = np.fromiter(
                        (TIER_CODE[jobs[i].tier] for i in done_now),
                        np.int64,
                        done_now.size,
                    )
                self._ev.append_batch(
                    t1,
                    E_COMPLETE,
                    job=done_now,
                    cluster=cl,
                    tier=tc,
                    gpus=self._alloc[done_now].astype(np.int64),
                )
            self._done[done_now] = True
            self._alloc[done_now] = 0
            nm = self.fleet.node_map
            if nm is not None:
                for i in done_now:
                    nm.release(int(i))  # row == trace index
            if self._table is not None:
                # release-on-completion: final state is written to the
                # columns, then the tick's finishers detach in one batch
                # (state copied back to the instances, rows freed)
                self._progress[done_now] = 1.0
                self._table.done_at[done_now] = t1
                for i in done_now:
                    _release_account(jobs[i])
                self._table.detach_batch(done_now)
            else:
                for i in done_now:
                    jobs[i].progress = 1.0
                    jobs[i].done_at = t1
                    jobs[i].allocated = 0
                    _release_account(jobs[i])

    def _run_vectorized_loop(self) -> None:
        cfg = self.cfg
        self._build_arrays()
        jobs = self._jobs_list
        n = len(jobs)
        act = np.empty(0, dtype=np.int64)
        ptr = 0
        t = 0.0
        while t <= cfg.horizon_seconds + 1e-9:
            self._advance_vec(act, t - self.now)
            # activate arrivals in (prev tick, t]; they queued since arrival
            hi = int(np.searchsorted(self._arr_sorted, t, side="right"))
            if hi > ptr:
                newly = self._arr_order[ptr:hi]
                self.queue_seconds += float(np.sum(t - self._arrival[newly]))
                act = np.concatenate([act, newly])
                ptr = hi
            self.now = t
            self.events_processed += 1
            if self._done[act].any():
                act = act[~self._done[act]]
            if ptr >= n and act.size == 0:
                break
            if act.size:
                if self._table is not None:
                    # zero-gather decide path: the policy slices the
                    # table's columns at these slots, _apply's property
                    # writes land in the same columns — no job-object
                    # walks, no resync, and reliability mutates live
                    # state through the views
                    active_jobs = self._table.view(act)
                    if self._reliability:
                        if self._has_failures:
                            self._process_failures(active_jobs)
                        if self.cfg.cadence is not None:
                            self._cadence_snapshots_vec(act)
                else:
                    active_jobs = [jobs[i] for i in act]
                    if self._reliability:
                        # failures/cadence read and mutate per-job
                        # progress: sync the arrays out, tick
                        # reliability, sync back
                        for i in act:
                            jobs[i].progress = float(self._progress[i])
                        for j in self._tick_reliability(active_jobs):
                            i = self._index[j.id]
                            self._alloc[i] = j.allocated
                            self._progress[i] = j.progress
                            self._downtime_until[i] = j.downtime_until
                if self.serving is not None:
                    self._serving_begin(t)
                if self.tele is not None:
                    self.tele.prof.set_anchor(t)
                decision = self.policy.decide(t, active_jobs, self.fleet)
                if self.tele is not None:
                    with self.tele.prof.span("apply"):
                        self._apply(decision)
                else:
                    self._apply(decision)
                self._frag_defrag_tick(active_jobs)
                if self._table is None:
                    for i in act:
                        self._alloc[i] = jobs[i].allocated
                        self._downtime_until[i] = jobs[i].downtime_until
                if self.serving is not None and self._svc_open:
                    self._serving_end(t)
                if self.tele is not None:
                    self._record_tick_metrics(t)
            t += cfg.tick_seconds
        # final sync for jobs still in flight at the horizon (table-backed
        # jobs read the live columns; nothing to sync)
        if self._table is None:
            for i in range(n):
                if not self._done[i]:
                    jobs[i].progress = float(self._progress[i])

    # ==========================================================================

    def run(self) -> SimResult:
        if self.cfg.vectorized:
            self._run_vectorized_loop()
        else:
            self._run_legacy_loop()

        total_gpu_seconds = self.fleet.total() * self.now if self.now else 1.0
        jobs = list(self.jobs.values())
        done = [j for j in jobs if j.done_at is not None]
        sla, jct = {}, {}
        downtime = {t: 0.0 for t in TIERS}
        for j in jobs:
            downtime[j.tier] += j.downtime_seconds
        for tier in TIERS:
            tjobs = [j for j in done if j.tier == tier]
            if not tjobs:
                continue
            ok = 0
            for j in tjobs:
                real = j.done_at - j.arrival
                frac = j.ideal_seconds / real if real > 0 else 1.0
                if frac >= TIERS[tier].gpu_fraction - 1e-9:
                    ok += 1
            sla[tier] = ok / len(tjobs)
            jct[tier] = float(np.mean([j.done_at - j.arrival for j in tjobs]))
        consumed = self.busy_gpu_seconds + self.gpu_seconds_dead
        goodput = (
            max(0.0, self.busy_gpu_seconds - self.lost_work_gpu_seconds) / consumed
            if consumed > 0
            else 1.0
        )
        goodput_vals: Dict[str, List[float]] = {t: [] for t in TIERS}
        for j in jobs:
            if j.arrival >= self.now or j.service:
                continue  # services never "complete"; SLO metrics cover them
            end = j.done_at if j.done_at is not None else self.now
            if end > j.arrival:
                goodput_vals[j.tier].append(
                    min(1.0, j.progress * j.ideal_seconds / (end - j.arrival))
                )
        goodput_by_tier = {
            t: float(np.mean(v)) for t, v in goodput_vals.items() if v
        }
        return SimResult(
            utilization=self.busy_gpu_seconds / total_gpu_seconds,
            sla_attainment=sla,
            mean_jct=jct,
            completed=len(done),
            total_jobs=len(jobs),
            preemptions=self.preemptions,
            migrations=self.migrations,
            resizes=self.resizes,
            queue_seconds=self.queue_seconds,
            gpu_seconds_idle=(
                total_gpu_seconds - self.busy_gpu_seconds - self.gpu_seconds_dead
            ),
            restores=self.restores,
            gpu_seconds_dead=self.gpu_seconds_dead,
            downtime_by_tier={t: v for t, v in downtime.items() if v > 0},
            migrations_cross_region=self.migrations_cross_region,
            restores_cross_region=self.restores_cross_region,
            failure_events=self.failure_events,
            job_failures=self.job_failures,
            snapshots=self.snapshots,
            lost_work_gpu_seconds=self.lost_work_gpu_seconds,
            goodput_fraction=goodput,
            goodput_by_tier=goodput_by_tier,
            restarts_by_cause=dict(self.restarts_by_cause),
            ettr_by_tier={
                t: self._ettr_sum[t] / self._ettr_n[t]
                for t in TIERS
                if self._ettr_n[t] > 0
            },
            fragmentation_stranded_gpus=(
                self._stranded_sum / self._frag_ticks if self._frag_ticks else 0.0
            ),
            defrag_migrations=self.defrag_migrations,
            **(self.serving.summary() if self.serving is not None else {}),
        )
