"""Fleet observability: structured event log, per-tick metrics series,
nested-span profiler, Perfetto trace export, and event-log replay.

Singularity is operated as a service: the paper's evaluation (§5,
Tables 3-5) attributes every second of dead GPU time to a concrete
preempt / migrate / resize / failure cause.  The simulator computes that
attribution internally but, before this module, threw it away and kept
only end-of-run aggregates in ``SimResult``.  This module makes the
attribution first-class:

- ``EventLog`` — a columnar struct-of-arrays log (the JobTable /
  FleetSLAAccounts recipe: doubling numpy columns, batched appends from
  the vectorized paths) of every lifecycle transition: admit, preempt,
  restore, migrate (incl. drain evacuation), resize, failure kill,
  snapshot, defrag move, loan, reclaim, complete.  Each row carries the
  sim time, the job's stable trace index, the fleet cluster index, SLA
  tier, a cause code, GPUs involved, and the CostModel-charged downtime
  seconds (lost work gpu-seconds for failure kills, reclaim latency for
  reclaims).  JSONL-exportable and reloadable.
- ``MetricsSeries`` — one row per scheduler tick (utilization, queue
  depth by tier, stranded GPUs, goodput, SLO attainment, loaned GPUs,
  decide-latency breakdown) in doubling float columns, CSV/JSON dump.
- ``Profiler`` — nested named spans replacing the ad-hoc
  ``decide_seconds`` / ``gather_seconds`` / ``node_seconds`` fields in
  ``policy.py``.  Per-name totals are always accumulated (two
  ``perf_counter`` calls per span, the same cost as the old fields);
  span *records* for trace export are only kept when the profiler is
  enabled, so telemetry-off runs stay near-zero-cost.
- ``export_chrome_trace`` — Chrome/Perfetto trace-event JSON: job
  lifecycle spans on per-cluster tracks (pid = cluster, tid = job slot)
  plus decide-pass phase spans on a scheduler track, wired up as
  ``benchmarks/sched_scale.py --trace-out``.
- ``replay_events`` / ``check_replay`` — the differential check: a pure
  function folds an exported event log back into the run's ``SimResult``
  aggregates (mechanism counts, downtime by tier, restarts by cause,
  lost work) and asserts equality, catching silent accounting drift
  between ``_apply`` and ``SimResult``.

The log is strictly *read-only* with respect to scheduling: every gate
in CI pins that decision digests are byte-identical with telemetry on.

A copy of ``repro.scheduler.telemetry``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""

from __future__ import annotations

import json
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.core.sla import TIERS
from repro_torch.scheduler.reliability import FAILURE_KINDS

TIER_NAMES = list(TIERS)

# ------------------------------------------------------------------ taxonomy
# Event kinds: one code per lifecycle transition.  Drain evacuation is a
# MIGRATE with cause "drain"; a failure kill is FAILURE with the
# FailureEvent kind (flake / power / outage / ...) as its cause.
EVENT_KINDS = (
    "admit",
    "preempt",
    "restore",
    "migrate",
    "resize",
    "failure",
    "snapshot",
    "defrag",
    "loan",
    "reclaim",
    "complete",
)
KIND_CODE = {name: i for i, name in enumerate(EVENT_KINDS)}

E_ADMIT = KIND_CODE["admit"]
E_PREEMPT = KIND_CODE["preempt"]
E_RESTORE = KIND_CODE["restore"]
E_MIGRATE = KIND_CODE["migrate"]
E_RESIZE = KIND_CODE["resize"]
E_FAILURE = KIND_CODE["failure"]
E_SNAPSHOT = KIND_CODE["snapshot"]
E_DEFRAG = KIND_CODE["defrag"]
E_LOAN = KIND_CODE["loan"]
E_RECLAIM = KIND_CODE["reclaim"]
E_COMPLETE = KIND_CODE["complete"]

# Cause vocabulary: scheduler-side causes first, then the reliability
# failure kinds (single source: reliability.FAILURE_KINDS), then serving,
# then curve pricing ("slope": a resize granted by the water-filling
# expansion pass on a curved job — appended last so existing codes in
# exported traces stay stable).
EVENT_CAUSES = ("", "policy", "preempt") + FAILURE_KINDS + ("spike", "slope")
CAUSE_CODE = {name: i for i, name in enumerate(EVENT_CAUSES)}

C_NONE = CAUSE_CODE[""]
C_POLICY = CAUSE_CODE["policy"]
C_PREEMPT = CAUSE_CODE["preempt"]
C_FAILURE = CAUSE_CODE["failure"]
C_DRAIN = CAUSE_CODE["drain"]
C_SPIKE = CAUSE_CODE["spike"]
C_SLOPE = CAUSE_CODE["slope"]

# flags bits
F_CROSS_REGION = 1

# Kinds whose ``seconds`` column is CostModel-charged downtime — exactly
# the ``_charge`` call sites in the simulator.  FAILURE rows carry lost
# work (gpu-seconds) instead; RECLAIM rows carry reclaim latency.
CHARGE_KINDS = frozenset(
    (E_RESTORE, E_MIGRATE, E_RESIZE, E_SNAPSHOT, E_DEFRAG)
)


class EventLog:
    """Columnar append-only log of fleet lifecycle events.

    Columns are flat numpy arrays that double on demand (no per-event
    Python object allocation); the vectorized simulator paths append
    whole batches at once.  ``job`` is the job's stable trace index
    (slot == trace index while a simulation runs; service index for
    loan/reclaim rows; -1 when not applicable).
    """

    _COLUMNS = (
        ("time", np.float64, 0.0),
        ("kind", np.int16, 0),
        ("job", np.int64, -1),
        ("cluster", np.int32, -1),
        ("tier", np.int8, -1),
        ("cause", np.int16, 0),
        ("gpus", np.int64, 0),
        ("seconds", np.float64, 0.0),
        ("flags", np.int8, 0),
    )

    def __init__(self, capacity: int = 1024):
        self._cap = max(int(capacity), 1)
        self.n = 0
        for name, dtype, fill in self._COLUMNS:
            setattr(self, "_" + name, np.full(self._cap, fill, dtype))

    def __len__(self) -> int:
        return self.n

    def column(self, name: str) -> np.ndarray:
        """The live prefix of a column (a view, not a copy)."""
        return getattr(self, "_" + name)[: self.n]

    def _grow(self, need: int) -> None:
        cap = self._cap
        while cap < need:
            cap *= 2
        for name, dtype, fill in self._COLUMNS:
            old = getattr(self, "_" + name)
            new = np.full(cap, fill, dtype)
            new[: self.n] = old[: self.n]
            setattr(self, "_" + name, new)
        self._cap = cap

    # ------------------------------------------------------------- appends
    def append(
        self,
        time: float,
        kind: int,
        job: int = -1,
        cluster: int = -1,
        tier: int = -1,
        cause: int = 0,
        gpus: int = 0,
        seconds: float = 0.0,
        flags: int = 0,
    ) -> None:
        i = self.n
        if i >= self._cap:
            self._grow(i + 1)
        self._time[i] = time
        self._kind[i] = kind
        self._job[i] = job
        self._cluster[i] = cluster
        self._tier[i] = tier
        self._cause[i] = cause
        self._gpus[i] = gpus
        self._seconds[i] = seconds
        self._flags[i] = flags
        self.n = i + 1

    def append_batch(
        self,
        time,
        kind,
        job,
        cluster=-1,
        tier=-1,
        cause=0,
        gpus=0,
        seconds=0.0,
        flags=0,
    ) -> None:
        """Append ``len(job)`` rows at once; scalars broadcast.

        Semantically identical to calling :meth:`append` per row in
        order — pinned by the batched-vs-scalar oracle test.
        """
        job = np.asarray(job)
        m = int(job.size)
        if m == 0:
            return
        i = self.n
        if i + m > self._cap:
            self._grow(i + m)
        sl = slice(i, i + m)
        self._time[sl] = time
        self._kind[sl] = kind
        self._job[sl] = job
        self._cluster[sl] = cluster
        self._tier[sl] = tier
        self._cause[sl] = cause
        self._gpus[sl] = gpus
        self._seconds[sl] = seconds
        self._flags[sl] = flags
        self.n = i + m

    # -------------------------------------------------------------- export
    def rows(self) -> Iterable[Dict]:
        """Decoded event dicts, in append order."""
        for i in range(self.n):
            yield {
                "t": float(self._time[i]),
                "kind": EVENT_KINDS[self._kind[i]],
                "job": int(self._job[i]),
                "cluster": int(self._cluster[i]),
                "tier": TIER_NAMES[self._tier[i]] if self._tier[i] >= 0 else "",
                "cause": EVENT_CAUSES[self._cause[i]],
                "gpus": int(self._gpus[i]),
                "seconds": float(self._seconds[i]),
                "cross": bool(self._flags[i] & F_CROSS_REGION),
            }

    def to_jsonl(self, path: str, meta: Optional[Dict] = None) -> None:
        """One meta header line, then one JSON object per event.

        ``json`` round-trips float64 exactly (shortest repr), so a log
        reloaded with :func:`read_jsonl` replays bit-identically.
        """
        with open(path, "w") as f:
            header = {"meta": dict(meta or {})}
            header["meta"].setdefault("version", 1)
            header["meta"].setdefault("events", self.n)
            f.write(json.dumps(header, sort_keys=True) + "\n")
            for row in self.rows():
                f.write(json.dumps(row, sort_keys=True) + "\n")


def read_jsonl(path: str) -> Tuple["EventLog", Dict]:
    """Reload a :meth:`EventLog.to_jsonl` export; returns (log, meta)."""
    log = EventLog()
    meta: Dict = {}
    tier_code = {name: i for i, name in enumerate(TIER_NAMES)}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "meta" in d:
                meta = d["meta"]
                continue
            log.append(
                time=d["t"],
                kind=KIND_CODE[d["kind"]],
                job=d["job"],
                cluster=d["cluster"],
                tier=tier_code.get(d["tier"], -1),
                cause=CAUSE_CODE[d["cause"]],
                gpus=d["gpus"],
                seconds=d["seconds"],
                flags=F_CROSS_REGION if d.get("cross") else 0,
            )
    return log, meta


# ----------------------------------------------------------------- metrics
class MetricsSeries:
    """Per-tick fleet metrics in doubling float64 ring columns.

    One ``record`` call per scheduler tick; every field defaults to 0.0
    when not supplied, so callers only fill what they measured.
    """

    FIELDS = (
        "time",
        "allocated_gpus",
        "utilization",
        "queue_premium",
        "queue_standard",
        "queue_basic",
        "stranded_gpus",
        "loaned_gpus",
        "goodput",
        "slo_attainment",
        "decide_seconds",
        "place_seconds",
        "apply_seconds",
    )

    def __init__(self, fields: Tuple[str, ...] = FIELDS, capacity: int = 256):
        self.fields = tuple(fields)
        self._cap = max(int(capacity), 1)
        self.n = 0
        self._cols = {f: np.zeros(self._cap, np.float64) for f in self.fields}

    def __len__(self) -> int:
        return self.n

    def column(self, name: str) -> np.ndarray:
        return self._cols[name][: self.n]

    def record(self, **values: float) -> None:
        i = self.n
        if i >= self._cap:
            cap = self._cap * 2
            for f, col in self._cols.items():
                new = np.zeros(cap, np.float64)
                new[:i] = col[:i]
                self._cols[f] = new
            self._cap = cap
        for f in self.fields:
            self._cols[f][i] = values.get(f, 0.0)
        self.n = i + 1

    def to_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(",".join(self.fields) + "\n")
            for i in range(self.n):
                f.write(
                    ",".join(repr(float(self._cols[c][i])) for c in self.fields)
                    + "\n"
                )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {c: self.column(c).tolist() for c in self.fields},
                f,
                sort_keys=True,
            )


# ---------------------------------------------------------------- profiler
class _Span:
    """One live nested span; re-entered via ``with prof.span(name)``."""

    __slots__ = ("prof", "name", "t0", "depth")

    def __init__(self, prof: "Profiler", name: str):
        self.prof = prof
        self.name = name

    def __enter__(self) -> "_Span":
        p = self.prof
        self.depth = p._depth
        p._depth = self.depth + 1
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        p = self.prof
        p._depth = self.depth
        p.totals[self.name] = p.totals.get(self.name, 0.0) + (t1 - self.t0)
        p.counts[self.name] = p.counts.get(self.name, 0) + 1
        if p.enabled:
            p.spans.append(
                (self.name, self.depth, p._anchor, p._anchor_wall, self.t0, t1)
            )


class Profiler:
    """Nested named wall-clock spans.

    Totals (``total(name)``) accumulate whether or not the profiler is
    enabled — they back ``ElasticPolicy.gather_seconds`` /
    ``node_seconds`` at the exact cost of the old ad-hoc
    ``perf_counter`` pairs.  Span *records* (for Perfetto export) are
    only kept when ``enabled``; a disabled profiler records nothing.

    ``set_anchor(sim_time)`` pins the current simulated time so wall
    durations can be projected onto the simulation timeline at export.
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        # (name, depth, anchor_sim, anchor_wall, t0, t1)
        self.spans: List[Tuple[str, int, float, float, float, float]] = []
        self._depth = 0
        self._anchor = 0.0
        self._anchor_wall = 0.0

    def span(self, name: str) -> _Span:
        return _Span(self, name)

    def total(self, name: str) -> float:
        return self.totals.get(name, 0.0)

    def set_anchor(self, sim_time: float) -> None:
        self._anchor = float(sim_time)
        self._anchor_wall = time.perf_counter()

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.spans.clear()
        self._depth = 0


class FleetTelemetry:
    """The bundle a simulator (or executor) run emits into.

    ``events`` is the structured lifecycle log, ``metrics`` the per-tick
    series, ``prof`` the (enabled) decide-pass profiler.  ``meta``
    collects run facts (reliability on/off, cluster names, ...) that the
    JSONL export and the replay check consume.
    """

    def __init__(
        self,
        events: Optional[EventLog] = None,
        metrics: Optional[MetricsSeries] = None,
        profiler: Optional[Profiler] = None,
    ):
        self.events = events if events is not None else EventLog()
        self.metrics = metrics if metrics is not None else MetricsSeries()
        self.prof = profiler if profiler is not None else Profiler(enabled=True)
        self.meta: Dict = {}


# ------------------------------------------------------------------ replay
def replay_events(log: EventLog) -> Dict:
    """Fold an event log back into ``SimResult``-shaped aggregates.

    Pure function of the log.  Float sums follow the simulator's exact
    accumulation order — sequential in event order for lost work,
    per-job-then-per-tier for downtime — so equality against the live
    ``SimResult`` is exact, not approximate.
    """
    kind = log.column("kind")
    secs = log.column("seconds")
    jobs = log.column("job")
    tiers = log.column("tier")
    cause = log.column("cause")
    flags = log.column("flags")
    cross = (flags & F_CROSS_REGION) != 0

    def count(k: int) -> int:
        return int((kind == k).sum())

    # lost work accumulates one failure kill at a time in the simulator
    lost = 0.0
    for v in secs[kind == E_FAILURE]:
        lost += float(v)

    # downtime: the simulator sums charges per job chronologically
    # (j.downtime_seconds), then folds jobs into tiers in trace order
    per_job: Dict[int, float] = {}
    job_tier: Dict[int, int] = {}
    charge = np.isin(kind, list(CHARGE_KINDS))
    for j, t, v in zip(jobs[charge], tiers[charge], secs[charge]):
        j = int(j)
        per_job[j] = per_job.get(j, 0.0) + float(v)
        job_tier[j] = int(t)
    downtime_by_tier = {t: 0.0 for t in TIER_NAMES}
    for j in sorted(per_job):
        downtime_by_tier[TIER_NAMES[job_tier[j]]] += per_job[j]
    downtime_by_tier = {t: v for t, v in downtime_by_tier.items() if v > 0}

    restore = kind == E_RESTORE
    restarts_by_cause: Dict[str, int] = {}
    for c in cause[restore]:
        name = EVENT_CAUSES[c]
        restarts_by_cause[name] = restarts_by_cause.get(name, 0) + 1

    return {
        "preemptions": count(E_PREEMPT),
        "restores": count(E_RESTORE),
        "restores_cross_region": int(cross[restore].sum()),
        "migrations": count(E_MIGRATE) + count(E_DEFRAG),
        "migrations_cross_region": int(cross[kind == E_MIGRATE].sum()),
        "resizes": count(E_RESIZE),
        "defrag_migrations": count(E_DEFRAG),
        "snapshots": count(E_SNAPSHOT),
        "job_failures": count(E_FAILURE),
        "lost_work_gpu_seconds": lost,
        "downtime_by_tier": downtime_by_tier,
        "restarts_by_cause": restarts_by_cause,
        "completed": count(E_COMPLETE),
    }


def check_replay(log: EventLog, result, reliability: bool = True) -> List[str]:
    """Compare :func:`replay_events` against a live ``SimResult``.

    Returns a list of human-readable mismatches (empty = exact match).
    ``restarts_by_cause`` is only attributed by the simulator when the
    reliability subsystem is active, so it is only compared then.
    """
    rep = replay_events(log)
    mismatches = []

    def eq(key, got, want):
        if got != want:
            mismatches.append(f"{key}: replay={got!r} result={want!r}")

    eq("preemptions", rep["preemptions"], result.preemptions)
    eq("restores", rep["restores"], result.restores)
    eq(
        "restores_cross_region",
        rep["restores_cross_region"],
        result.restores_cross_region,
    )
    eq("migrations", rep["migrations"], result.migrations)
    eq(
        "migrations_cross_region",
        rep["migrations_cross_region"],
        result.migrations_cross_region,
    )
    eq("resizes", rep["resizes"], result.resizes)
    eq("defrag_migrations", rep["defrag_migrations"], result.defrag_migrations)
    eq("snapshots", rep["snapshots"], result.snapshots)
    eq("job_failures", rep["job_failures"], result.job_failures)
    eq(
        "lost_work_gpu_seconds",
        rep["lost_work_gpu_seconds"],
        result.lost_work_gpu_seconds,
    )
    eq("downtime_by_tier", rep["downtime_by_tier"], result.downtime_by_tier)
    eq("completed", rep["completed"], result.completed)
    if reliability:
        eq(
            "restarts_by_cause",
            rep["restarts_by_cause"],
            result.restarts_by_cause,
        )
    return mismatches


# ----------------------------------------------------------------- perfetto
def export_chrome_trace(
    path: str,
    events: Optional[EventLog] = None,
    profiler: Optional[Profiler] = None,
    cluster_names: Optional[List[str]] = None,
    job_ids: Optional[List[str]] = None,
    end_time: Optional[float] = None,
) -> int:
    """Write a Chrome/Perfetto trace-event JSON file.

    Job lifecycle spans land on per-cluster tracks: pid = cluster index
    + 1 (pid 0 is the scheduler), tid = the job's trace index.  A span
    opens at admit/restore, closes at preempt / failure / completion,
    and a migration (or defrag move) closes the span on the old cluster
    and opens one on the new — so a job's residency history reads
    directly off the timeline.  Timestamps are simulated seconds in
    microseconds.

    Decide-pass profiler spans render on the scheduler track (pid 0):
    each span is anchored at the simulated time of its tick and offset
    by its wall-clock time within the tick, so a ~10 ms decide shows as
    a 10 "µs-per-wall-ms" sliver you zoom into at each tick boundary.
    Nesting is by timestamp containment (Perfetto's rule for same-tid
    ``X`` events).

    Returns the number of trace events written.
    """
    trace: List[Dict] = []

    def pname(pid: int, name: str) -> None:
        trace.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid,
                "args": {"name": name},
            }
        )

    pname(0, "scheduler")
    for k, cname in enumerate(cluster_names or []):
        pname(k + 1, f"cluster {cname}")

    def job_label(slot: int) -> str:
        if job_ids is not None and 0 <= slot < len(job_ids):
            return job_ids[slot]
        return f"job{slot}"

    n_events = 0
    if events is not None:
        kinds = events.column("kind")
        times = events.column("time")
        jobs = events.column("job")
        clusters = events.column("cluster")
        gpus = events.column("gpus")
        last_t = float(times[-1]) if events.n else 0.0
        horizon = last_t if end_time is None else float(end_time)
        open_spans: Dict[int, Tuple[float, int, int]] = {}

        def close(slot: int, t: float, why: str) -> None:
            t0, cl, g = open_spans.pop(slot)
            trace.append(
                {
                    "name": job_label(slot),
                    "cat": "job",
                    "ph": "X",
                    "ts": t0 * 1e6,
                    "dur": max(t - t0, 0.0) * 1e6,
                    "pid": int(cl) + 1,
                    "tid": int(slot),
                    "args": {"gpus": int(g), "end": why},
                }
            )

        for i in range(events.n):
            k = int(kinds[i])
            slot = int(jobs[i])
            t = float(times[i])
            if k in (E_ADMIT, E_RESTORE):
                if slot in open_spans:  # defensive: restore over a live span
                    close(slot, t, "restore")
                open_spans[slot] = (t, int(clusters[i]), int(gpus[i]))
            elif k in (E_MIGRATE, E_DEFRAG):
                if slot in open_spans:
                    close(slot, t, EVENT_KINDS[k])
                open_spans[slot] = (t, int(clusters[i]), int(gpus[i]))
            elif k in (E_PREEMPT, E_FAILURE, E_COMPLETE):
                if slot in open_spans:
                    close(slot, t, EVENT_KINDS[k])
        for slot in sorted(open_spans):
            close(slot, horizon, "end-of-run")
        n_events = events.n

    if profiler is not None:
        for name, depth, anchor, anchor_wall, t0, t1 in profiler.spans:
            ts = anchor + (t0 - anchor_wall)
            trace.append(
                {
                    "name": name,
                    "cat": "decide",
                    "ph": "X",
                    "ts": ts * 1e6,
                    "dur": (t1 - t0) * 1e6,
                    "pid": 0,
                    "tid": 0,
                    "args": {"depth": int(depth)},
                }
            )

    with open(path, "w") as f:
        json.dump({"traceEvents": trace}, f)
    return len(trace)
