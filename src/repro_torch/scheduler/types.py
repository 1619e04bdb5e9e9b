"""Fleet and job model for the planet-scale scheduler simulation.

A copy of ``repro.scheduler.types``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, List, Optional

from repro_torch.core.sla import TIERS, FleetSLAAccounts, GpuFractionAccount, SLAAccount
from repro_torch.scheduler.costs import RegionTopology, default_checkpoint_bytes
from repro_torch.scheduler.curves import scaling_eff, validate_curve

if TYPE_CHECKING:  # avoid the import cycle: job_table/node_map view Job
    from repro_torch.scheduler.job_table import JobTable
    from repro_torch.scheduler.node_map import NodeMap


@dataclasses.dataclass
class Cluster:
    """One cluster: ``total_gpus`` devices grouped into nodes of
    ``gpus_per_node`` (the failure-domain granularity between a single
    device flake and a whole-cluster outage).  ``dead_gpus`` is capacity
    currently taken out by an unrepaired failure; ``draining`` marks a
    planned drain in its advance-warning window (the policy avoids
    placing onto draining clusters and proactively migrates off them)
    with ``drain_deadline`` the wall time capacity actually dies."""

    id: str
    region: str
    total_gpus: int
    free_gpus: int = -1
    gpus_per_node: int = 8
    dead_gpus: int = 0
    draining: bool = False
    drain_deadline: float = 0.0

    def __post_init__(self):
        if self.free_gpus < 0:
            self.free_gpus = self.total_gpus

    def nodes(self) -> int:
        return max(1, -(-self.total_gpus // max(self.gpus_per_node, 1)))

    def node_capacities(self) -> List[int]:
        """Per-node GPU counts.  Ceil division used to pad a trailing
        partial node up to ``gpus_per_node``; the node vector keeps its
        TRUE smaller capacity so placement and failure blast radius see
        the hardware that exists."""
        gpn = max(self.gpus_per_node, 1)
        full, rem = divmod(self.total_gpus, gpn)
        caps = [gpn] * full
        if rem or not caps:
            caps.append(rem)
        return caps

    def capacity(self) -> int:
        """GPUs currently healthy (total minus failed-out capacity)."""
        return max(0, self.total_gpus - self.dead_gpus)


@dataclasses.dataclass
class Region:
    id: str
    clusters: List[Cluster]

    def total(self) -> int:
        return sum(c.total_gpus for c in self.clusters)

    def free(self) -> int:
        return sum(c.free_gpus for c in self.clusters)

    def capacity(self) -> int:
        return sum(c.capacity() for c in self.clusters)


@dataclasses.dataclass
class Fleet:
    """The global scheduler's world model: regions of clusters plus the
    inter-region transfer topology the cost model prices migrations
    against (``None`` = region-blind, every pair at blob bandwidth), the
    shared SLA ledger all active jobs' accounts live in (``None`` =
    per-job scalar accounts), and the shared ``JobTable`` the driver's
    jobs are adopted into (``None`` = plain scalar ``Job`` objects)."""

    regions: List[Region]
    topology: Optional[RegionTopology] = None
    sla: Optional[FleetSLAAccounts] = None
    jobs: Optional["JobTable"] = None
    # node-granular placement state owned by the current driver (None =
    # cluster-granular placement only, the pre-NodeMap behaviour); the
    # policy plans node spans exactly when this is attached
    node_map: Optional["NodeMap"] = None

    def total(self) -> int:
        return sum(r.total() for r in self.regions)

    def capacity(self) -> int:
        """Healthy GPUs fleet-wide — what the scheduler may allocate
        while failed-out domains await repair."""
        return sum(r.capacity() for r in self.regions)

    def free(self) -> int:
        return sum(r.free() for r in self.regions)

    def clusters(self) -> List[Cluster]:
        return [c for r in self.regions for c in r.clusters]

    def cluster_index(self) -> dict:
        """Cluster id -> flat fleet index, in ``clusters()`` order
        (cached; clusters are static for a fleet's lifetime).  The
        simulator's apply path and the telemetry event log both key
        clusters by this index."""
        idx = self.__dict__.get("_cluster_index")
        if idx is None:
            idx = {c.id: k for k, c in enumerate(self.clusters())}
            self.__dict__["_cluster_index"] = idx
        return idx

    def region_of(self, cluster_id: Optional[str]) -> Optional[str]:
        """Region id owning ``cluster_id`` (cached; clusters are static
        for a fleet's lifetime)."""
        if cluster_id is None:
            return None
        by_cluster = self.__dict__.get("_region_by_cluster")
        if by_cluster is None:
            by_cluster = {c.id: r.id for r in self.regions for c in r.clusters}
            self.__dict__["_region_by_cluster"] = by_cluster
        return by_cluster.get(cluster_id)


@dataclasses.dataclass
class Job:
    """A training job: demands N GPUs of work ``gpu_hours`` total.

    ``min_gpus`` encodes the ZeRO partial-sharding limit (§5.4): the job
    cannot be spliced below demand/max_splice devices.  ``elastic`` and
    ``preemptible`` are ALWAYS true in Singularity (the paper's point);
    the static baseline policy ignores them.
    """

    id: str
    tier: str  # premium | standard | basic
    demand_gpus: int
    gpu_hours: float  # total work in (demand_gpus x hours)
    arrival: float  # seconds
    min_gpus: int = 1
    splice_overhead: float = 0.03  # Fig-4 measured time-slicing overhead
    checkpoint_bytes: int = 0  # deduped snapshot size (Table 4); 0 = estimate
    # concave scaling curve (scheduler/curves.py): efficiency rises at
    # slope 1/demand up to the saturation knee, then at sat_slope/demand
    # to the 2x cap.  knee_gpus == 0 is the flat sentinel — the seed's
    # linear model exactly, so pre-curve traces stay byte-identical.
    knee_gpus: int = 0
    sat_slope: float = 1.0
    # latency-SLO serving replica group (scheduler/serving.py): demand is
    # retargeted every tick by the autoscaler and the policy must never
    # expand it past demand (replicas beyond the target buy no SLO)
    service: bool = False

    # runtime state
    allocated: int = 0
    cluster: Optional[str] = None
    progress: float = 0.0  # in [0, 1]
    done_at: Optional[float] = None
    preemptions: int = 0
    migrations: int = 0
    resizes: int = 0
    # filled by __post_init__ with a scalar account when the caller does
    # not supply one; the simulator/executor swap in a ledger-backed
    # FleetSlotAccount view so fleet-wide queries batch
    account: Optional[SLAAccount] = None
    # wall time this job last entered the queue (arrival, or the moment
    # of its last preemption); the policy's fairness aging reads it
    queued_since: float = -1.0
    # NodeMap row holding this job's node span (-1 = no driver assigned
    # one); set once by the simulator/executor, stable across the job's
    # lifetime — deliberately NOT a JobTable column, so it survives
    # adopt/detach untouched
    node_slot: int = -1

    # cost accounting (set by the simulator's cost model)
    downtime_until: float = 0.0  # no progress before this wall time
    downtime_seconds: float = 0.0  # total dead time charged so far
    restore_debt: float = 0.0  # preempt cost carried into the next restore
    ever_ran: bool = False  # has a checkpoint to restore from

    # reliability state (maintained by the simulator's failure machinery):
    # a durable snapshot exists at progress ``snap_progress`` taken at wall
    # time ``snap_time``; an unplanned failure rolls progress back to it.
    snap_progress: float = 0.0
    # None = "no snapshot recorded yet": __post_init__ fills the arrival
    # (initial state is restartable).  A sentinel, not a <= 0 clamp, so a
    # replayed/restored job with a legitimate snapshot AT t=0 keeps it.
    snap_time: Optional[float] = None
    failures: int = 0  # unplanned failures that killed this job's domain
    failed_at: Optional[float] = None  # pending failure awaiting restart

    def __post_init__(self):
        assert self.tier in TIERS
        if self.demand_gpus < 1:
            raise ValueError(
                f"job {self.id}: demand_gpus must be >= 1, got "
                f"{self.demand_gpus} (ideal_seconds divides by it)"
            )
        if not 1 <= self.min_gpus <= self.demand_gpus:
            raise ValueError(
                f"job {self.id}: min_gpus must satisfy 1 <= min_gpus <= "
                f"demand_gpus, got min_gpus={self.min_gpus} with "
                f"demand_gpus={self.demand_gpus}"
            )
        try:
            validate_curve(self.demand_gpus, self.knee_gpus, self.sat_slope)
        except ValueError as e:
            raise ValueError(f"job {self.id}: {e}") from None
        if self.account is None:
            self.account = GpuFractionAccount(self.tier, self.demand_gpus)
        if self.queued_since < 0.0:
            self.queued_since = self.arrival
        if self.checkpoint_bytes <= 0:
            self.checkpoint_bytes = default_checkpoint_bytes(self.demand_gpus)
        if self.snap_time is None:
            self.snap_time = self.arrival  # initial state = restartable

    @property
    def ideal_seconds(self) -> float:
        return self.gpu_hours * 3600.0 / self.demand_gpus

    def rate(self) -> float:
        """Progress per second given current allocation (work-conserving
        elasticity; scaled-down jobs pay the splicing overhead).  Above
        the saturation knee the marginal GPU buys only ``sat_slope`` of
        a linear GPU (scheduler/curves.py); the flat sentinel
        ``knee_gpus == 0`` keeps the seed's linear model."""
        if self.allocated <= 0 or self.done_at is not None:
            return 0.0
        eff = scaling_eff(
            self.allocated, self.demand_gpus, self.knee_gpus, self.sat_slope
        )
        if self.allocated < self.demand_gpus:
            eff *= 1.0 - self.splice_overhead
        return eff / self.ideal_seconds

    def remaining_seconds(self) -> float:
        r = self.rate()
        return float("inf") if r <= 0 else (1.0 - self.progress) / r
