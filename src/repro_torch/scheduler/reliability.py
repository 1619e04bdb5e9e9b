"""Reliability subsystem: failure-domain fault injection, checkpoint
cadence, and goodput accounting at fleet scale.

Singularity's reliability claim (§1, §6) is that because every job is
preemptible and resumable from a transparent checkpoint, an unplanned
hardware failure is just another preemption: the job loses only the work
since its last snapshot and restarts wherever capacity exists.  The
scheduler layers reproduce the *planned* mechanisms (preempt / migrate /
resize, charged by ``CostModel``); this module supplies the *unplanned*
half:

- ``FailureModel`` samples correlated failure events over the fleet's
  device -> node -> cluster -> region domain hierarchy.  Each level has
  its own per-unit MTBF and repair time; inter-arrival times are Weibull
  (shape 1.0 = exponential; shape < 1 models infant-mortality bursts)
  drawn from deterministic per-level Philox streams, so a seed fully
  determines the storm.
- ``FailureTrace`` is the replayable artifact: an ordered event list
  with JSON (de)serialization plus scenario constructors — single-device
  flakes, rack power loss, whole-cluster outage, region drain with
  advance warning — so benchmarks and tests can replay named storms.
- ``CheckpointCadence`` picks each job's snapshot interval from its
  checkpoint cost versus its domain failure rate (Young–Daly:
  ``tau = sqrt(2 * delta * MTTI)``), trading snapshot downtime against
  expected lost work.

``FleetSimulator`` consumes a trace (``SimConfig(failures=...)``): a
failure force-preempts every job intersecting the domain, rolls progress
back to the last snapshot (the lost work is accounted as
``lost_work_gpu_seconds``), marks the domain's capacity dead until a
sampled repair completes, and attributes the eventual restart downtime
by cause.  When the fleet carries a ``NodeMap`` the blast radius is
exact: a partial-domain event kills only the jobs whose assigned node
spans intersect the failed nodes (idle capacity absorbs the hit first),
instead of sampling victims proportionally from the cluster's residents.  ``ElasticPolicy`` avoids placing onto draining domains and
proactively migrates off them when the move costs less than the work it
saves.  ``SimResult`` reports ``goodput_fraction``, ``restarts_by_cause``
and per-tier ETTR so reliability wins are measurable.

A copy of ``repro.scheduler.reliability``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.scheduler.costs import CostModel

FAILURE_LEVELS = ("device", "node", "cluster", "region")

# Event-kind vocabulary: "failure" is the generic unplanned event, the
# named scenarios refine it (ECC flake, rack power, cluster outage,
# planned drain).  telemetry.py folds these into its cause-code table so
# a FAILURE row in the event log says *what kind* of failure killed the
# job — keep this tuple the single source of that vocabulary.
FAILURE_KINDS = ("failure", "flake", "power", "outage", "drain")

# stable per-level stream offsets: adding a level or resampling one never
# perturbs the others' streams
_LEVEL_STREAM = {level: i for i, level in enumerate(FAILURE_LEVELS)}


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One failure-domain event.

    ``domain`` is a cluster id for device/node/cluster levels and a
    region id for region level.  ``gpus`` is the capacity taken out
    (0 = the whole domain).  ``warning_seconds > 0`` marks a *planned*
    drain: the scheduler sees the domain as draining from
    ``time - warning_seconds`` and can migrate work off proactively.
    """

    time: float
    level: str
    domain: str
    gpus: int
    repair_seconds: float
    warning_seconds: float = 0.0
    kind: str = "failure"

    def __post_init__(self):
        assert self.level in FAILURE_LEVELS, self.level
        assert self.kind in FAILURE_KINDS, self.kind

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict) -> "FailureEvent":
        return cls(**d)


class FailureTrace:
    """A replayable, time-ordered failure scenario.

    Traces are the unit of scenario diversity: sample one from a
    ``FailureModel``, build one from the named constructors below, merge
    several, save to JSON and replay byte-identically later.
    """

    def __init__(self, events: Iterable[FailureEvent] = ()):
        self.events: List[FailureEvent] = sorted(
            events, key=lambda e: (e.time, e.domain, e.level)
        )

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    def __eq__(self, other) -> bool:
        return isinstance(other, FailureTrace) and self.events == other.events

    # ------------------------------------------------------- persistence
    def to_json(self) -> str:
        return json.dumps([e.to_dict() for e in self.events], indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FailureTrace":
        return cls(FailureEvent.from_dict(d) for d in json.loads(text))

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "FailureTrace":
        with open(path) as f:
            return cls.from_json(f.read())

    @classmethod
    def merge(cls, *traces: "FailureTrace") -> "FailureTrace":
        return cls(e for t in traces for e in t.events)

    # ------------------------------------------------- named scenarios
    @classmethod
    def device_flake(
        cls, cluster_id: str, at: float, repair_seconds: float = 1800.0
    ) -> "FailureTrace":
        """One GPU in ``cluster_id`` drops out (ECC flake, XID error)."""
        return cls(
            [FailureEvent(at, "device", cluster_id, 1, repair_seconds, kind="flake")]
        )

    @classmethod
    def rack_power_loss(
        cls,
        cluster_id: str,
        at: float,
        nodes: int = 4,
        gpus_per_node: int = 8,
        repair_seconds: float = 4 * 3600.0,
    ) -> "FailureTrace":
        """A rack PDU trips: ``nodes`` nodes in one cluster die at once."""
        return cls(
            [
                FailureEvent(
                    at,
                    "node",
                    cluster_id,
                    nodes * gpus_per_node,
                    repair_seconds,
                    kind="power",
                )
            ]
        )

    @classmethod
    def cluster_outage(
        cls, cluster_id: str, at: float, repair_seconds: float = 8 * 3600.0
    ) -> "FailureTrace":
        """The whole cluster goes dark (network partition, cooling)."""
        return cls(
            [FailureEvent(at, "cluster", cluster_id, 0, repair_seconds, kind="outage")]
        )

    @classmethod
    def region_drain(
        cls,
        region_id: str,
        at: float,
        repair_seconds: float = 12 * 3600.0,
        warning_seconds: float = 2 * 3600.0,
    ) -> "FailureTrace":
        """Planned maintenance: the region drains with advance warning —
        the scheduler can move work off before capacity actually dies."""
        return cls(
            [
                FailureEvent(
                    at,
                    "region",
                    region_id,
                    0,
                    repair_seconds,
                    warning_seconds=warning_seconds,
                    kind="drain",
                )
            ]
        )


@dataclasses.dataclass(frozen=True)
class FailureModel:
    """Correlated failure sampling over the fleet's domain hierarchy.

    Per-level MTBF is *per unit* (per GPU, per node, per cluster, per
    region): the aggregate arrival rate at a level scales with how many
    units the fleet has, which is what makes big fleets fail somewhere
    all the time even when each part is reliable.  ``weibull_shape``
    shapes inter-arrival times (1.0 = memoryless exponential; < 1 gives
    the bursty infant-mortality clustering real fleets show).  Repair
    times are exponential around each level's mean.  All streams are
    per-level Philox generators keyed off ``seed`` — the same seed and
    fleet always produce the same trace.
    """

    device_mtbf_seconds: float = 5.0 * 365 * 24 * 3600.0
    node_mtbf_seconds: float = 2.0 * 365 * 24 * 3600.0
    cluster_mtbf_seconds: float = 0.5 * 365 * 24 * 3600.0
    region_drain_interval_seconds: float = 0.0  # 0 = no scheduled drains
    weibull_shape: float = 1.0
    device_repair_seconds: float = 1800.0
    node_repair_seconds: float = 4 * 3600.0
    cluster_repair_seconds: float = 8 * 3600.0
    region_drain_seconds: float = 12 * 3600.0
    drain_warning_seconds: float = 2 * 3600.0
    seed: int = 0
    max_events: int = 100_000  # per level, so one hot level cannot starve the rest

    # ------------------------------------------------------------ rates
    def level_rate(self, level: str, units: int) -> float:
        """Aggregate events/second at a level with ``units`` units."""
        mtbf = {
            "device": self.device_mtbf_seconds,
            "node": self.node_mtbf_seconds,
            "cluster": self.cluster_mtbf_seconds,
            "region": self.region_drain_interval_seconds,
        }[level]
        if mtbf <= 0:
            return 0.0
        return units / mtbf

    def job_failure_rate(self, demand_gpus, gpus_per_node: int = 8):
        """Unplanned-failure rate (events/second) seen by a job spanning
        ``demand_gpus`` GPUs: its devices, the nodes they sit on, and the
        one cluster it runs in.  Planned region drains are excluded — the
        scheduler migrates off those, it does not lose work to them.
        Broadcasts over numpy arrays for the vectorized cadence path.
        """
        demand = np.asarray(demand_gpus, np.float64)
        nodes = np.ceil(demand / max(gpus_per_node, 1))
        rate = (
            demand / self.device_mtbf_seconds
            + nodes / self.node_mtbf_seconds
            + 1.0 / self.cluster_mtbf_seconds
        )
        return rate if rate.ndim else float(rate)

    # ---------------------------------------------------------- sampling
    def _stream(self, level: str) -> np.random.Generator:
        return np.random.Generator(
            np.random.Philox(key=np.array([self.seed, _LEVEL_STREAM[level]], np.uint64))
        )

    def _interarrival(self, rng: np.random.Generator, rate: float) -> float:
        mean = 1.0 / rate
        if self.weibull_shape == 1.0:
            return float(rng.exponential(mean))
        scale = mean / math.gamma(1.0 + 1.0 / self.weibull_shape)
        return float(scale * rng.weibull(self.weibull_shape))

    def sample(self, fleet, horizon_seconds: float) -> FailureTrace:
        """Sample a full trace for ``fleet`` over ``horizon_seconds``.

        Device/node events land in a cluster chosen proportionally to its
        unit count; cluster outages and region drains pick a domain
        uniformly.  Deterministic in (seed, fleet shape, horizon).
        """
        clusters = fleet.clusters()
        if not clusters:
            return FailureTrace()
        sizes = np.array([c.total_gpus for c in clusters], np.float64)
        node_counts = np.array([c.nodes() for c in clusters], np.float64)
        events: List[FailureEvent] = []

        def weighted(rng, weights) -> int:
            return int(rng.choice(len(clusters), p=weights / weights.sum()))

        plans: List[Tuple[str, float, Sequence]] = [
            ("device", self.level_rate("device", int(sizes.sum())), sizes),
            ("node", self.level_rate("node", int(node_counts.sum())), node_counts),
            ("cluster", self.level_rate("cluster", len(clusters)), None),
            ("region", self.level_rate("region", len(fleet.regions)), None),
        ]
        for level, rate, weights in plans:
            if rate <= 0:
                continue
            rng = self._stream(level)
            t = 0.0
            n_level = 0
            while n_level < self.max_events:
                n_level += 1
                t += self._interarrival(rng, rate)
                if t > horizon_seconds:
                    break
                if level == "device":
                    k = weighted(rng, weights)
                    events.append(
                        FailureEvent(
                            t,
                            "device",
                            clusters[k].id,
                            1,
                            float(rng.exponential(self.device_repair_seconds)),
                            kind="flake",
                        )
                    )
                elif level == "node":
                    k = weighted(rng, weights)
                    events.append(
                        FailureEvent(
                            t,
                            "node",
                            clusters[k].id,
                            clusters[k].gpus_per_node,
                            float(rng.exponential(self.node_repair_seconds)),
                            kind="power",
                        )
                    )
                elif level == "cluster":
                    k = int(rng.integers(0, len(clusters)))
                    events.append(
                        FailureEvent(
                            t,
                            "cluster",
                            clusters[k].id,
                            0,
                            float(rng.exponential(self.cluster_repair_seconds)),
                            kind="outage",
                        )
                    )
                else:
                    k = int(rng.integers(0, len(fleet.regions)))
                    events.append(
                        FailureEvent(
                            t,
                            "region",
                            fleet.regions[k].id,
                            0,
                            self.region_drain_seconds,
                            warning_seconds=self.drain_warning_seconds,
                            kind="drain",
                        )
                    )
        return FailureTrace(events)


@dataclasses.dataclass(frozen=True)
class CheckpointCadence:
    """Per-job snapshot interval from checkpoint cost vs failure rate.

    Young–Daly: with snapshot overhead ``delta`` (seconds of downtime per
    snapshot, ``CostModel.snapshot_seconds``) and mean time to interrupt
    ``M = 1/lambda`` from the job's domain failure rate, the optimal
    cadence is ``tau = sqrt(2 * delta * M)``.  Cheap checkpoints and
    flaky domains mean frequent snapshots; huge checkpoints on reliable
    hardware mean rare ones.  ``mtti_seconds`` overrides the model-derived
    rate for controlled experiments.  Intervals clamp to
    ``[min_interval_seconds, max_interval_seconds]``.
    """

    cost_model: CostModel = dataclasses.field(default_factory=CostModel)
    failure_model: Optional[FailureModel] = None
    mtti_seconds: Optional[float] = None
    min_interval_seconds: float = 300.0
    max_interval_seconds: float = 24 * 3600.0

    def interval_seconds(self, checkpoint_bytes, demand_gpus, gpus_per_node: int = 8):
        """Snapshot interval(s); broadcasts over numpy arrays."""
        delta = np.asarray(
            self.cost_model.snapshot_seconds(np.asarray(checkpoint_bytes, np.float64)),
            np.float64,
        )
        if self.mtti_seconds is not None:
            mtti = np.asarray(self.mtti_seconds, np.float64)
        else:
            model = self.failure_model or FailureModel()
            rate = np.asarray(
                model.job_failure_rate(demand_gpus, gpus_per_node), np.float64
            )
            mtti = 1.0 / np.maximum(rate, 1e-12)
        tau = np.sqrt(2.0 * delta * mtti)
        tau = np.clip(tau, self.min_interval_seconds, self.max_interval_seconds)
        return tau if tau.ndim else float(tau)
