"""Scheduling policies.

``ElasticPolicy`` is Singularity's: every job is preemptible, migratable and
elastic, so the scheduler (a) never leaves capacity idle while work is
queued (opportunistic scale-up of running jobs / admission of basic jobs
anywhere in the fleet), (b) shrinks before it preempts, preempts strictly
by tier, (c) defragments by migrating small jobs to open contiguous
capacity for large arrivals, all while respecting GPU-fraction SLAs.

Three properties distinguish it from the seed policy:

**Cost-aware.**  When a ``CostModel`` is attached (the simulator and the
executor thread theirs in automatically), decisions weigh the mechanisms'
real downtime instead of treating them as free:

- *Victim ranking* — within a tier, running jobs are admitted ahead of
  queued ones and ranked by the downtime a preemption+restore of them
  would burn per GPU freed (``preempt_seconds + restore_seconds``); so
  when capacity forces evictions, the victims are the jobs with small
  ``checkpoint_bytes`` — the cheap ones to stop (Aryl's weighting).
- *Shrink-before-queue gate* — comfort-shrinking a job into leftover
  capacity is only worth a restore/resize whose downtime is shorter than
  the scheduling interval; otherwise the mechanism would eat the whole
  tick it was meant to exploit.
- *Expansion gate* — opportunistic scale-up of an already-running job
  triggers a splice resize; a chunk of extra GPUs is only granted when
  the productive GPU-seconds it delivers in one interval — priced on
  the job's concave scaling curve (``scheduler/curves.py``), not a
  linear fiction — exceed the dead GPU-seconds the resize charges.
  Spare capacity is *water-filled* in descending marginal-slope order:
  pre-knee chunks (marginal gain of one interval per GPU, the seed's
  linear pricing, and the whole chunk for flat-curve jobs) fill first
  in scale-up-priority order, then post-knee chunks by descending
  ``sat_slope``; a job's post-knee chunk is reachable only once its
  pre-knee chunk filled (concavity).  ``curve_aware=False`` restores
  linear pricing — the A/B arm ``benchmarks/sched_scale.py --curves``
  measures against.
- *Region-aware placement* — a running job that must move is placed in
  its current region when any same-region cluster fits, because the cost
  model prices cross-region migrations at the slower inter-region blob
  tier.
- *Reliability-aware placement* — only HEALTHY capacity is allocatable
  (failed-out domains await repair), draining domains are avoided when a
  healthy cluster fits, and a running job evacuates a draining cluster
  proactively when one migration costs less than the work a failure
  would destroy (unsnapshotted progress plus the forced restore).

**Fair under permanent overload.**  Victim ranking alone lets a queued
guaranteed job starve forever behind running peers that are expensive to
stop.  Admission-order *fairness aging* fixes that: a guaranteed job
queued longer than ``aging_threshold_intervals`` scheduling intervals
accrues a bonus of ``aging_rate`` cost-seconds per excess second queued
(a float, or a per-tier mapping so premium ages faster than standard),
and competes in the running-job class with that bonus as its score — once
the bonus exceeds a running peer's preempt+restore downtime, the aged job
is admitted ahead of it.  When the queue drains (or within the
threshold), the ordering is exactly the unaged one, so aging is a no-op
on healthy fleets.

**Vectorized.**  ``decide`` runs as numpy array passes — lexsort for the
admission/expansion/placement orders, cumsum-based greedy capacity fits,
and one batched ``FleetSLAAccounts.headroom_all`` call for the SLA state
of every guaranteed job (no per-job account queries remain on the decide
path when jobs carry ledger-backed accounts) — so million-job traces
clear in minutes (``benchmarks/sched_scale.py``).  When the driver's
jobs live in a fleet ``JobTable`` (the production setup: the simulator
and the executor adopt theirs at construction), even the per-job
*attribute gather* disappears: the decide pass slices the table's
columns directly, the ledger slots come from the ``sla_slot`` column,
and the ``Decision`` carries its array form (``table_update``) so the
simulator applies it with masked column writes.  Hand-built scalar
``Job`` lists keep the per-job build path; mixed or foreign-table lists
are detected (``job_table.shared_table``) and fall back the same way
``_shared_ledger`` does.
``ElasticPolicy(vectorized=False)`` keeps a pure-Python reference oracle
with identical semantics; ``tests/test_policy_equivalence.py`` proves the
two paths emit byte-identical decisions on random fleets, and
``tests/test_job_table.py`` proves the table path is indistinguishable
from plain jobs.

``StaticGangPolicy`` is the status-quo baseline: jobs are gang-scheduled at
full demand in FIFO order, never preempted, never resized — the comparison
that motivates the paper (§1: utilization/idling).

A copy of ``repro.scheduler.policy``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping as MappingABC
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.core.sla import TIERS, FleetSlotAccount
from repro_torch.scheduler.costs import CostModel
from repro_torch.scheduler.job_table import TIER_CODE, JobView, shared_table
from repro_torch.scheduler.node_map import (
    floor_gang,
    gang_down,
    gang_down_vec,
    gang_values,
    splice_divisors,
)
from repro_torch.scheduler.telemetry import Profiler
from repro_torch.scheduler.types import Fleet, Job

DEFAULT_INTERVAL_SECONDS = 300.0

# tier attributes as numpy lookup tables: one dict hit per job instead of
# three TIERS consultations on the decide hot path (codes shared with the
# JobTable's tier_code column)
_TIER_CODE = TIER_CODE
_TIER_PRIO = np.array([TIERS[t].preempt_priority for t in TIERS], np.int64)
_TIER_SUP = np.array([TIERS[t].scaleup_priority for t in TIERS], np.int64)
_TIER_GFRAC = np.array([TIERS[t].gpu_fraction for t in TIERS], np.float64)


class _TableAlloc(MappingABC):
    """``Decision.alloc`` backed by the decide pass's arrays.

    The simulator's table-aware ``_apply`` consumes the array form
    directly, so for table-backed fleets the per-job ``{id: (gpus,
    cluster)}`` dict never needs to exist; it materializes lazily (and
    identically) for anyone who reads the mapping — digest wrappers,
    the executor, hand-written consumers."""

    __slots__ = ("_ids", "_gpus", "_placed", "_cluster_ids", "_dict")

    def __init__(self, ids, gpus, placed, cluster_ids):
        self._ids = ids
        self._gpus = gpus
        self._placed = placed
        self._cluster_ids = cluster_ids
        self._dict: Optional[Dict[str, Tuple[int, Optional[str]]]] = None

    def _materialize(self) -> Dict[str, Tuple[int, Optional[str]]]:
        if self._dict is None:
            cids = self._cluster_ids
            placed = self._placed
            gpus = self._gpus
            self._dict = {
                jid: (
                    int(gpus[i]),
                    cids[placed[i]] if placed[i] >= 0 else None,
                )
                for i, jid in enumerate(self._ids)
            }
        return self._dict

    def __getitem__(self, key):
        return self._materialize()[key]

    def __iter__(self):
        return iter(self._materialize())

    def __len__(self) -> int:
        return len(self._ids)

    def items(self):
        return self._materialize().items()


@dataclasses.dataclass
class Decision:
    """Target allocation for the next interval: job -> (gpus, cluster)."""

    alloc: Mapping[str, Tuple[int, Optional[str]]]
    preemptions: List[str]
    migrations: List[str]
    # array form of ``alloc`` when the decide pass ran over a JobTable
    # whose cluster codes index ``fleet.clusters()``: ``(table, slots,
    # gpus, placed)`` with ``placed`` a cluster index (-1 = unplaced).
    # The simulator applies it with masked column writes instead of a
    # per-job Python loop; consumers that only know the mapping ignore it.
    table_update: Optional[tuple] = None
    # node placement plan when the fleet carries a NodeMap: ``(node_map,
    # released_rows, assigns)`` where ``assigns`` is [(row, nodes, gpus)].
    # The simulator commits it in ``_apply``; decisions without one (the
    # static baseline, hand-written policies) get an auto-fit span.
    node_plan: Optional[tuple] = None
    # ids of jobs whose grant includes a curve-priced (slope-gated)
    # expansion chunk this interval — the simulator tags their resize
    # events with the ``slope`` cause.  None when no such grant was made
    # (all-flat fleets, curve_aware=False).  Sorted for path equality.
    slope_expanded: Optional[Tuple[str, ...]] = None


class StaticGangPolicy:
    """FIFO gang scheduling without preemption/elasticity."""

    name = "static"

    def decide(self, now: float, jobs: List[Job], fleet: Fleet) -> Decision:
        # healthy capacity only: failed-out GPUs are not allocatable
        free = {c.id: c.capacity() for c in fleet.clusters()}
        for j in jobs:
            if j.done_at is None and j.allocated > 0:
                free[j.cluster] -= j.allocated
        alloc: Dict[str, Tuple[int, Optional[str]]] = {}
        for j in sorted(jobs, key=lambda j: j.arrival):
            if j.done_at is not None:
                continue
            if j.allocated > 0:
                alloc[j.id] = (j.allocated, j.cluster)  # never touched again
                continue
            # admit only if some cluster fits the FULL demand
            for cid, f in free.items():
                if f >= j.demand_gpus:
                    alloc[j.id] = (j.demand_gpus, cid)
                    free[cid] -= j.demand_gpus
                    break
            else:
                alloc[j.id] = (0, None)
        return Decision(alloc=alloc, preemptions=[], migrations=[])


def _greedy_take(
    wants: np.ndarray, floors: np.ndarray, cap: int, partial: bool
) -> Tuple[np.ndarray, int]:
    """Greedy capacity fit along an already-ordered candidate axis.

    Each candidate takes its full ``want`` when that fits in the remaining
    capacity; with ``partial=True`` a candidate whose full want no longer
    fits may instead take everything left, provided that is still at or
    above its ``floor``.  Equivalent to the per-job reference loop, but
    runs as cumsum rounds: every round admits a whole prefix at once, so
    the number of rounds is bounded by the number of skipped boundary
    candidates, not by the job count.

    Returns the granted array (aligned with ``wants``) and the capacity
    left over.
    """
    gives = np.zeros(wants.size, dtype=np.int64)
    remaining = int(cap)
    # a candidate whose full want is below its own floor can never be
    # granted anything (partial grants are capacity splits, not floor
    # relaxations), matching the reference loop's give >= floor check
    active = np.flatnonzero((wants > 0) & (wants >= floors))
    while active.size and remaining > 0:
        active = active[floors[active] <= remaining]
        if not active.size:
            break
        prefix = np.cumsum(wants[active])
        fit = prefix <= remaining
        k = int(np.argmin(fit)) if not fit.all() else int(active.size)
        if k > 0:
            taken = active[:k]
            gives[taken] = wants[taken]
            remaining -= int(prefix[k - 1])
        if k >= active.size:
            break
        boundary = active[k]
        if partial and remaining >= floors[boundary]:
            gives[boundary] = remaining  # full want no longer fits
            remaining = 0
        tail = k + 1
        active = active[tail:]
    return gives, remaining


def _gang_topup(
    galloc: np.ndarray, demand: np.ndarray, prio: np.ndarray, rem: int
) -> None:
    """Hand gang-rounding's shavings back: climb shrunk jobs up the
    splice-divisor ladder toward full demand while spare capacity lasts
    (highest tier, largest grant, lowest index first).  Without this a
    grant like 51-of-64 rounds to 32 and the 19 freed GPUs idle; with it
    they finance the next divisor step.  In-place; candidates are only
    jobs holding GPUs below demand, so the trip count is bounded by the
    running-job count, not queue depth.  Both decide paths call this
    exact routine, so grants cannot drift between them."""
    if rem <= 0:
        return
    cand = np.flatnonzero((galloc > 0) & (galloc < demand))
    if not cand.size:
        return
    order = cand[np.lexsort((cand, -galloc[cand], -prio[cand]))]
    for i in order:
        g = int(galloc[i])
        divs = splice_divisors(int(demand[i]))
        p = int(np.searchsorted(np.asarray(divs, np.int64), g, side="right"))
        while p < len(divs) and divs[p] - g <= rem:
            rem -= divs[p] - g
            g = divs[p]
            p += 1
        galloc[i] = g
        if rem <= 0:
            break


def _shared_ledger(accs: list):
    """(ledger, slots) when every account is a view on one
    ``FleetSLAAccounts``; (None, None) otherwise (mixed or scalar
    accounts fall back to the per-job oracle loop)."""
    ledger = None
    slots = np.empty(len(accs), np.int64)
    for k, acc in enumerate(accs):
        if not isinstance(acc, FleetSlotAccount):
            return None, None
        if ledger is None:
            ledger = acc.ledger
        elif acc.ledger is not ledger:
            return None, None
        slots[k] = acc.slot
    return ledger, slots


class ElasticPolicy:
    """Singularity's policy: SLA-tiered, shrink-before-preempt, elastic
    expansion into spare capacity, migration-based defragmentation —
    cost-aware, aging-fair and vectorized (see module docstring)."""

    name = "elastic"

    def __init__(
        self,
        expand_factor: float = 2.0,
        cost_model: Optional[CostModel] = None,
        interval_hint: Optional[float] = None,
        vectorized: bool = True,
        aging_rate: Union[float, Mapping[str, float]] = 1.0,
        aging_threshold_intervals: float = 12.0,
        node_batch: bool = True,
        curve_aware: bool = True,
    ):
        self.expand_factor = expand_factor
        # price expansion/shrink on each job's concave scaling curve
        # (curves.py).  False treats every curve as flat — the seed's
        # linear pricing — while the simulator still *progresses* jobs on
        # their true curves; the bench's --curves A/B arm flips this
        self.curve_aware = curve_aware
        # threaded in by FleetSimulator/FleetExecutor when left unset, so
        # the policy always prices decisions with the charged model
        self.cost_model = cost_model
        self.interval_hint = interval_hint
        self.vectorized = vectorized
        # node placement core: batched array passes (production) or the
        # per-job loop oracle the batched core is digest-checked against
        self.node_batch = node_batch
        # fairness aging: a guaranteed job queued longer than
        # aging_threshold_intervals ticks accrues aging_rate cost-seconds
        # of admission credit per excess second; 0 disables aging.  A
        # mapping gives per-tier rates (premium can age faster than
        # standard); tiers absent from the mapping do not age.
        self.aging_rate = aging_rate
        if isinstance(aging_rate, Mapping):
            self._aging_by_tier = {t: float(aging_rate.get(t, 0.0)) for t in TIERS}
        else:
            self._aging_by_tier = {t: float(aging_rate) for t in TIERS}
        self._aging_vec = np.array(
            [self._aging_by_tier[t] for t in TIERS], np.float64
        )
        self.aging_threshold_intervals = aging_threshold_intervals
        self._bound_cost = False
        self._bound_interval = False
        # unified decide-pass profiler (telemetry.Profiler).  Totals
        # always accumulate at the exact cost of the old ad-hoc
        # ``gather_seconds``/``node_seconds`` fields (two perf_counter
        # calls per span); per-span records for trace export are kept
        # only once a FleetTelemetry is bound via ``bind_telemetry``.
        self.prof = Profiler()

    @property
    def decide_seconds(self) -> float:
        """Wall seconds spent inside ``decide`` since construction."""
        return self.prof.total("decide")

    @property
    def gather_seconds(self) -> float:
        """Share of decide time spent gathering per-job state into
        arrays inside ``_decide_vectorized`` (the base-array build, or
        the JobTable column slicing that replaces it); benchmarks
        report the split."""
        return self.prof.total("gather")

    @property
    def node_seconds(self) -> float:
        """Share of decide time spent inside the node-granular
        placement pass; benchmarks gate it separately."""
        return self.prof.total("place")

    def bind_telemetry(self, telemetry) -> None:
        """Adopt a ``FleetTelemetry``'s profiler so this policy's spans
        land in the shared trace (called by the simulator when
        ``SimConfig.telemetry`` is set)."""
        self.prof = telemetry.prof

    def bind_costs(self, cost_model: CostModel, interval_hint: float) -> None:
        """Thread the driver's charged cost model and tick length into
        this policy.  Values the caller configured explicitly are never
        overwritten; values a previous bind installed are — so one policy
        object can be reused across simulators/executors with different
        cost configurations without silently pricing decisions with a
        stale model."""
        if self.cost_model is None or self._bound_cost:
            self.cost_model = cost_model
            self._bound_cost = True
        if self.interval_hint is None or self._bound_interval:
            self.interval_hint = interval_hint
            self._bound_interval = True

    # -- shared scalar helpers (both paths must agree bit-for-bit) --------
    def _interval(self) -> float:
        if self.interval_hint is not None:
            return self.interval_hint
        return DEFAULT_INTERVAL_SECONDS

    def _required(self, now: float, j: Job) -> int:
        """GPUs needed this interval to keep the job's hourly SLA safe."""
        tier = TIERS[j.tier]
        if tier.gpu_fraction <= 0:
            return 0  # basic: best effort
        # fraction delivered so far this window; demand enough to stay above
        if j.account.headroom(now) > 0.1:
            # comfortably above guarantee -> can run shrunk this interval
            # (with a margin so the hourly window stays safe)
            frac = min(1.0, tier.gpu_fraction + 0.1)
            return max(j.min_gpus, int(j.demand_gpus * frac))
        return j.demand_gpus

    def _victim_cost(self, j: Job) -> float:
        """Downtime burned per GPU freed by preempting-then-restoring this
        job (checkpoint-size-driven under the derived model); expensive
        jobs are kept running, cheap ones are victimized.  Deliberately
        NOT weighted by the job's size: per GPU freed the downtime is the
        same, and preferring small victims only multiplies event count."""
        if self.cost_model is None or j.allocated <= 0:
            return 0.0
        cb = j.checkpoint_bytes
        return self.cost_model.preempt_seconds(cb) + self.cost_model.restore_seconds(
            cb
        )

    def _restart_cost(self, j: Job) -> float:
        """Downtime a restart/resize of this job would charge right now.

        The restore term is the region-blind (intra) price — a lower
        bound, since the destination cluster is only chosen later in
        placement; the simulator charges the true pair-priced cost."""
        if self.cost_model is None:
            return 0.0
        if j.allocated > 0:
            return self.cost_model.resize_seconds(j.checkpoint_bytes)
        if j.ever_ran:
            return self.cost_model.restore_seconds(j.checkpoint_bytes) + j.restore_debt
        return 0.0

    def decide(self, now: float, jobs: List[Job], fleet: Fleet) -> Decision:
        with self.prof.span("decide"):
            return self._decide(now, jobs, fleet)

    def _decide(self, now: float, jobs: List[Job], fleet: Fleet) -> Decision:
        if isinstance(jobs, JobView):
            # table-backed fast path: the active filter is a masked
            # column read, no per-job Python at all
            t, s = jobs.table, jobs.slots
            keep = np.isnan(t.done_at[s]) & (t.arrival[s] <= now)
            if not keep.all():
                s = s[keep]
            if s.size == 0:
                return Decision(alloc={}, preemptions=[], migrations=[])
            if self.vectorized:
                return self._decide_vectorized(now, JobView(t, s), fleet)
            return self._decide_reference(now, list(JobView(t, s)), fleet)
        active = [j for j in jobs if j.done_at is None and j.arrival <= now]
        if not active:
            return Decision(alloc={}, preemptions=[], migrations=[])
        if self.vectorized:
            return self._decide_vectorized(now, active, fleet)
        return self._decide_reference(now, active, fleet)

    # ================= vectorized path (the production path) =============
    def _decide_vectorized(
        self, now: float, active: List[Job], fleet: Fleet
    ) -> Decision:
        n = len(active)
        interval = self._interval()
        cm = self.cost_model
        # gather every job's numeric state into arrays.  Table-backed
        # jobs (the production setup): column slices straight out of the
        # shared JobTable, zero per-job Python.  Hand-built scalar jobs:
        # one pass over the objects into a single (n, 8) float64 array
        # (exact — GPU counts and byte sizes are far below 2**53), tier
        # attributes via code lookup tables.  Mixed or foreign-table
        # lists fall back to the object path, like _shared_ledger.
        with self.prof.span("gather"):
            table, slots = shared_table(active)
            if table is not None:
                demand = table.demand_gpus[slots]
                min_g = table.min_gpus[slots]
                alloc0 = table.allocated[slots]
                arrival = table.arrival[slots]
                tcode = table.tier_code[slots]
                qsince = table.queued_since[slots]
                cb = table.checkpoint_bytes[slots].astype(np.float64)
                debt = table.restore_debt[slots]
                ran = table.ever_ran[slots]
                svc = table.service[slots]
                knee = table.knee_gpus[slots]
                sat = table.sat_slope[slots]
            else:
                base = np.array(
                    [
                        (
                            j.demand_gpus,
                            j.min_gpus,
                            j.allocated,
                            j.arrival,
                            j.checkpoint_bytes,
                            j.restore_debt,
                            _TIER_CODE[j.tier],
                            j.queued_since,
                            j.service,
                            j.knee_gpus,
                            j.sat_slope,
                        )
                        for j in active
                    ],
                    dtype=np.float64,
                ).reshape(n, 11)
                demand = base[:, 0].astype(np.int64)
                min_g = base[:, 1].astype(np.int64)
                alloc0 = base[:, 2].astype(np.int64)
                arrival = base[:, 3]
                tcode = base[:, 6].astype(np.int64)
                qsince = base[:, 7]
                cb = base[:, 4]
                debt = base[:, 5]
                svc = base[:, 8] > 0.5
                knee = base[:, 9].astype(np.int64)
                sat = base[:, 10]
                ran = None  # gathered lazily, when a cost model needs it
        prio = _TIER_PRIO[tcode]
        sup = _TIER_SUP[tcode]
        gfrac = _TIER_GFRAC[tcode]
        running = alloc0 > 0
        guar = gfrac > 0.0
        # jobs whose scaling curve the policy prices (knee_gpus == 0 is
        # the flat/linear sentinel; curve_aware=False flattens them all)
        curved = (knee > 0) & self.curve_aware

        # SLA headroom: ONE batched ledger query when the guaranteed jobs
        # carry FleetSLAAccounts-backed accounts (the production setup —
        # table-adopted accounts mirror their ledger slots into the
        # sla_slot column, so not even the account objects are touched);
        # hand-built jobs with scalar accounts fall back to the oracle loop
        with self.prof.span("sla"):
            head = np.full(n, np.inf)
            gidx = np.flatnonzero(guar)
            if gidx.size:
                if (
                    table is not None
                    and table.sla is not None
                    and bool(table.sla_view[slots[gidx]].all())
                ):
                    head[gidx] = table.sla.headroom_all(
                        now, table.sla_slot[slots[gidx]], gfrac[gidx]
                    )
                else:
                    gaccs = [active[i].account for i in gidx]
                    ledger, lslots = _shared_ledger(gaccs)
                    if ledger is not None:
                        head[gidx] = ledger.headroom_all(
                            now, lslots, gfrac[gidx]
                        )
                    else:
                        for k, i in enumerate(gidx):
                            head[i] = gaccs[k].headroom(now)
            shrunk = np.maximum(
                min_g, (demand * np.minimum(1.0, gfrac + 0.1)).astype(np.int64)
            )
            need = np.where(guar, np.where(head > 0.1, shrunk, demand), 0)

        if cm is None:
            vcost = np.zeros(n)
            restart = np.zeros(n)
            resize_s = np.zeros(n)
        else:
            if ran is None:
                ran = np.fromiter((j.ever_ran for j in active), bool, n)
            pre_s = np.broadcast_to(
                np.asarray(cm.preempt_seconds(cb), np.float64), (n,)
            )
            rest_s = np.broadcast_to(
                np.asarray(cm.restore_seconds(cb), np.float64), (n,)
            )
            resize_s = np.broadcast_to(
                np.asarray(cm.resize_seconds(cb), np.float64), (n,)
            )
            vcost = np.where(running, pre_s + rest_s, 0.0)
            restart = np.where(
                running,
                resize_s,
                np.where(ran, rest_s + debt, 0.0),
            )

        idx = np.arange(n)
        with self.prof.span("sort"):
            # fairness aging: a guaranteed job queued past the threshold
            # joins the running-job class, scored by its accrued bonus
            # against the running peers' preempt+restore downtime; rates
            # are per tier
            wait = now - qsince
            threshold = self.aging_threshold_intervals * interval
            rate = self._aging_vec[tcode]
            aged = (~running) & guar & (wait > threshold) & (rate > 0.0)
            score = np.where(
                running,
                vcost,
                np.where(aged, rate * (wait - threshold), 0.0),
            )
            waiting = (~(running | aged)).astype(np.int64)
            # admission order: tier first, serving replica groups ahead
            # of training within their tier (a reclaim retarget must
            # never wait on training admission); then the running jobs
            # and aged long-queued jobs come ahead of the plain queue,
            # ranked by how expensive they are to stop (or how starved
            # they are), then FIFO (lexsort: last key is primary)
            order_a = np.lexsort(
                (idx, arrival, -score, waiting, -svc.astype(np.int64), -prio)
            )
        # failed-out domains await repair: only healthy capacity is real
        total = fleet.capacity()
        galloc = np.zeros(n, dtype=np.int64)

        # 1. guaranteed tier demands, all-or-nothing per job: under
        #    overload it is better to run fewer jobs at guaranteed speed
        #    than all jobs too slow to meet any SLA
        w1 = need[order_a]
        g1, rem = _greedy_take(w1, w1, total, partial=False)
        galloc[order_a] = g1

        # 1b. shrink-before-queue: a guaranteed job whose full slice did
        #     not fit but which is comfortably above its hourly guarantee
        #     runs shrunk (>= min_gpus) instead of queueing — if the
        #     restart it takes costs less downtime than the interval buys.
        #     Curved jobs price the buy at the shrunk operating point
        #     (shrunk/demand of a nominal interval — the curve is linear
        #     below the knee), so a restart a full-size slice would
        #     justify no longer passes on a small one
        worth = np.where(curved, interval * (shrunk / demand), interval)
        cand = (galloc == 0) & (need > 0) & (head > 0.1) & (restart < worth)
        g1b, rem = _greedy_take(
            np.where(cand, demand, 0)[order_a], min_g[order_a], rem, True
        )
        galloc[order_a] += g1b

        # 2. top up to full demand, same order (the guarantee slice is
        #    already safe); a job skipped by the all-or-nothing pass must
        #    not be partially admitted here, and a best-effort job only
        #    at or above its splice floor
        skipped = (galloc == 0) & (need > 0)
        want2 = np.where(skipped, 0, demand - galloc)
        floor2 = np.where(galloc == 0, min_g, 1)
        g2, rem = _greedy_take(want2[order_a], floor2[order_a], rem, True)
        galloc[order_a] += g2

        # 3. opportunistic expansion into spare capacity — only with real
        #    fleet slack, only for jobs admitted this interval.  Greedy
        #    marginal-utility water-filling over the scaling curves
        #    (scheduler/curves.py): a job's headroom up to ``expand_factor
        #    x demand`` splits at its saturation knee into a pre-knee
        #    chunk whose marginal GPU earns one full interval (the seed's
        #    linear pricing — and the WHOLE chunk for flat-curve jobs)
        #    and a post-knee chunk whose marginal GPU earns only
        #    ``sat_slope`` of one.  Filling in global descending-slope
        #    order therefore collapses to two blocks: every pre-knee
        #    chunk first, in scale-up order, then post-knee chunks by
        #    descending ``sat_slope`` (ties to scale-up order); a job's
        #    post-knee chunk is reachable only once its pre-knee chunk
        #    filled (concavity).  Each chunk is gated on the
        #    CostModel-charged resize burn.  Serving replica groups never
        #    expand past their autoscaler target: replicas beyond it buy
        #    no SLO, only churn
        nm = fleet.node_map
        slope_rows = None
        if rem > 0.1 * total:
            extra = (demand * (self.expand_factor - 1.0)).astype(np.int64)
            target = galloc + extra
            end_a = np.where(curved, np.clip(knee, galloc, target), target)
            if nm is not None:
                # splice ladder: a curved chunk boundary must be a world
                # size gang rounding keeps — a multiple of demand (the
                # boundary sits at/above demand whenever it exceeds
                # galloc) — or pass 3b would round a knee-capped grant
                # back down.  Post-boundary capacity is then priced at
                # sat_slope: conservative when the snap moved the
                # boundary below the true knee
                end_a = np.where(
                    curved,
                    np.maximum(end_a - end_a % demand, galloc),
                    end_a,
                )
            d_a = end_a - galloc
            d_b = target - end_a
            slope_b = sat * interval
            if cm is None:
                gate_a = np.ones(n, dtype=bool)
                gate_b = gate_a
            else:
                free_event = ~running | (galloc != alloc0)
                gain_a = d_a.astype(np.float64) * interval
                burn_a = resize_s * (galloc + d_a).astype(np.float64)
                gate_a = free_event | (burn_a < gain_a)
                # past the knee, a job whose pre-knee chunk already paid
                # for the resize only needs the marginal GPU to out-earn
                # its own burn; a job sitting AT its knee pays the fixed
                # burn against the flat-slope gain instead
                burn_b = resize_s * (galloc + d_b).astype(np.float64)
                gate_b = np.where(
                    d_a > 0,
                    gate_a & (free_event | (slope_b > resize_s)),
                    free_event | (burn_b < slope_b * d_b.astype(np.float64)),
                )
            cand_a = (galloc > 0) & (d_a > 0) & gate_a & ~svc
            cand_b = (galloc > 0) & (d_b > 0) & gate_b & ~svc
            order_s = np.lexsort((idx, sup))
            ones = np.ones(n, dtype=np.int64)
            g3, rem = _greedy_take(
                np.where(cand_a, d_a, 0)[order_s], ones[order_s], rem, True
            )
            grant_a = np.zeros(n, dtype=np.int64)
            grant_a[order_s] = g3
            galloc += grant_a
            grant_b = np.zeros(n, dtype=np.int64)
            if rem > 0 and cand_b.any():
                # concavity: the cheap chunk must fill before the dear one
                cand_b &= (d_a == 0) | (grant_a == d_a)
                order_b = np.lexsort((idx, sup, -slope_b))
                g3b, rem = _greedy_take(
                    np.where(cand_b, d_b, 0)[order_b], ones[order_b], rem, True
                )
                grant_b[order_b] = g3b
                galloc += grant_b
            if curved.any():
                slope_rows = np.flatnonzero(curved & (grant_a + grant_b > 0))

        # 3b. gang/splice rounding (node-granular fleets): a grant must be
        #     a world size the splice mechanism supports — a divisor or
        #     multiple of demand — before placement shapes it onto nodes
        if nm is not None:
            galloc = gang_down_vec(galloc, demand)
            _gang_topup(galloc, demand, prio, int(total - galloc.sum()))

        # 4. enforce min_gpus (ZeRO partial-sharding floor): below it the
        #    job is preempted instead (checkpointed, zero lost work); only
        #    a job that was actually running is a preemption event
        below = (galloc > 0) & (galloc < min_g)
        preempt = below & running
        galloc[below] = 0

        # 5. placement
        galloc, placed, preempt, migrate, node_plan = self._place_vectorized(
            active, table, slots, fleet, galloc, min_g, demand, prio, running, preempt
        )

        clusters = fleet.clusters()
        if table is not None:
            ids = table.ids[slots]
        else:
            ids = [j.id for j in active]
        slope_expanded = (
            tuple(sorted(ids[i] for i in slope_rows))
            if slope_rows is not None and slope_rows.size
            else None
        )
        if table is not None:
            cluster_ids = [c.id for c in clusters]
            return Decision(
                alloc=_TableAlloc(ids, galloc, placed, cluster_ids),
                preemptions=sorted(ids[i] for i in np.flatnonzero(preempt)),
                migrations=sorted(ids[i] for i in np.flatnonzero(migrate)),
                table_update=(
                    (table, slots, galloc, placed)
                    if table.matches_clusters(cluster_ids)
                    else None
                ),
                node_plan=node_plan,
                slope_expanded=slope_expanded,
            )
        final: Dict[str, Tuple[int, Optional[str]]] = {}
        for i in range(n):
            cid = clusters[placed[i]].id if placed[i] >= 0 else None
            final[ids[i]] = (int(galloc[i]), cid)
        return Decision(
            alloc=final,
            preemptions=sorted(ids[i] for i in np.flatnonzero(preempt)),
            migrations=sorted(ids[i] for i in np.flatnonzero(migrate)),
            node_plan=node_plan,
            slope_expanded=slope_expanded,
        )

    def _place_vectorized(
        self,
        active: List[Job],
        table,
        slots: Optional[np.ndarray],
        fleet: Fleet,
        galloc: np.ndarray,
        min_g: np.ndarray,
        demand: np.ndarray,
        prio: np.ndarray,
        running: np.ndarray,
        preempt: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, Optional[tuple]]:
        """Bin-pack allocations into clusters: keep placements that still
        fit, then region-aware defragmentation for the rest.

        The stay-put pass is a per-cluster cumsum greedy; the residual
        loop only visits jobs that actually hold GPUs, so its trip count
        is bounded by fleet capacity, not by queue depth.  On a fleet
        carrying a NodeMap, placement descends to node granularity
        (``_place_nodes``) and the decision carries the span plan.
        """
        n = len(active)
        clusters = fleet.clusters()
        cid_index = {c.id: k for k, c in enumerate(clusters)}
        regions = {r.id: k for k, r in enumerate(fleet.regions)}
        creg = np.fromiter(
            (regions[fleet.region_of(c.id)] for c in clusters),
            np.int64,
            len(clusters),
        )
        if table is not None and table.matches_clusters(cid_index):
            # table cluster codes below len(clusters) index fleet.clusters()
            # directly; codes past it are clusters this fleet doesn't know
            # (same as the object path's cid_index miss -> -1)
            raw = table.cluster_idx[slots]
            has_cluster = raw >= 0
            jcl = np.where(raw < len(clusters), raw, -1)
        else:
            jcl = np.fromiter(
                (cid_index.get(j.cluster, -1) for j in active), np.int64, n
            )
            has_cluster = np.fromiter((j.cluster is not None for j in active), bool, n)
        jreg = np.where(jcl >= 0, creg[np.maximum(jcl, 0)], -1)
        drain = np.fromiter((c.draining for c in clusters), bool, len(clusters))
        nm = fleet.node_map
        if nm is not None:
            if table is not None:
                rows = slots  # drivers register node rows at table slots
            else:
                rows = np.fromiter((j.node_slot for j in active), np.int64, n)
            return self._place_nodes(
                nm,
                active,
                rows,
                galloc,
                min_g,
                demand,
                prio,
                running,
                preempt,
                jcl,
                has_cluster,
                jreg,
                creg,
                drain,
            )
        free = np.fromiter((c.capacity() for c in clusters), np.int64, len(clusters))
        idx = np.arange(n)
        # guaranteed tiers and large allocations place first so basic
        # absorbs fragmentation
        order_p = np.lexsort((idx, -galloc, -prio))
        placed = np.full(n, -1, dtype=np.int64)

        # proactive migration off draining domains: a running job on a
        # cluster in its drain-warning window loses its stay-put right
        # when moving now costs less downtime than the work a failure
        # would destroy (unsnapshotted progress + the restore it forces)
        no_stay = np.zeros(n, dtype=bool)
        any_drain = bool(drain.any())
        if any_drain:
            on_draining = (
                (jcl >= 0) & running & (galloc > 0) & drain[np.maximum(jcl, 0)]
            )
            for i in np.flatnonzero(on_draining):
                no_stay[i] = self._proactive_move(active[i])

        # keep existing placement when it still fits (no gratuitous moves)
        stay = order_p[
            (galloc[order_p] > 0) & (jcl[order_p] >= 0) & ~no_stay[order_p]
        ]
        for k in range(len(clusters)):
            sel = stay[jcl[stay] == k]
            if sel.size:
                g, left = _greedy_take(
                    galloc[sel], galloc[sel], int(free[k]), partial=False
                )
                placed[sel[g > 0]] = k
                free[k] = left

        migrate = np.zeros(n, dtype=bool)
        # only jobs that actually hold GPUs enter the Python loop: its
        # trip count is bounded by fleet capacity, not queue depth
        for i in order_p[galloc[order_p] > 0]:
            g = int(galloc[i])
            if g == 0 or placed[i] >= 0:
                continue
            fits = free >= g
            if fits.any():
                # defrag: most-free cluster, avoiding draining domains
                # when a healthy one fits; a running job prefers to stay
                # in-region (cross-region moves pay the slower blob tier)
                pool = fits
                if any_drain:
                    nd = fits & ~drain
                    if nd.any():
                        pool = nd
                if running[i] and jreg[i] >= 0:
                    same = pool & (creg == jreg[i])
                    if same.any():
                        pool = same
                k = int(np.argmax(np.where(pool, free, -1)))
                placed[i] = k
                free[k] -= g
            else:
                # cannot fit contiguously anywhere -> shrink to the
                # biggest hole (preferring healthy clusters), but never
                # below the ZeRO splice floor (§5.4): below that the job
                # is preempted
                if any_drain:
                    k = int(np.argmax(np.where(~drain, free, -1)))
                    if drain.all() or free[k] < min_g[i]:
                        k = int(np.argmax(free))
                else:
                    k = int(np.argmax(free))
                hole = int(free[k])
                if hole < min_g[i]:
                    galloc[i] = 0
                    if running[i]:
                        preempt[i] = True
                    continue
                galloc[i] = hole
                placed[i] = k
                free[k] = 0
            if running[i] and has_cluster[i] and placed[i] != jcl[i]:
                migrate[i] = True
        return galloc, placed, preempt, migrate, None

    def _place_nodes(
        self,
        nm,
        active: List[Job],
        rows: np.ndarray,
        galloc: np.ndarray,
        min_g: np.ndarray,
        demand: np.ndarray,
        prio: np.ndarray,
        running: np.ndarray,
        preempt: np.ndarray,
        jcl: np.ndarray,
        has_cluster: np.ndarray,
        jreg: np.ndarray,
        creg: np.ndarray,
        drain: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, tuple]:
        """Node placement entry for both decide paths: dispatch to the
        batched core (production) or the per-job loop it is
        digest-checked against (``node_batch=False``), accumulating the
        node-pass share of decide time in the profiler's ``place`` span
        (surfaced as ``node_seconds``)."""
        with self.prof.span("place"):
            core = (
                self._place_nodes_batched
                if self.node_batch
                else self._place_nodes_loop
            )
            return core(
                nm,
                active,
                rows,
                galloc,
                min_g,
                demand,
                prio,
                running,
                preempt,
                jcl,
                has_cluster,
                jreg,
                creg,
                drain,
            )

    def _place_nodes_loop(
        self,
        nm,
        active: List[Job],
        rows: np.ndarray,
        galloc: np.ndarray,
        min_g: np.ndarray,
        demand: np.ndarray,
        prio: np.ndarray,
        running: np.ndarray,
        preempt: np.ndarray,
        jcl: np.ndarray,
        has_cluster: np.ndarray,
        jreg: np.ndarray,
        creg: np.ndarray,
        drain: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, tuple]:
        """Node-granular placement over a ``PlacementOverlay``.

        Grants arrive gang-rounded.  An unchanged running job whose span
        already matches keeps it untouched (zero work — the common case
        that bounds decide time); every other span is released into the
        overlay and re-fit: first onto the job's own cluster when a gang
        fit exists there, then pool selection with the cluster-granular
        preferences (healthy over draining, same-region for running
        jobs, most aggregate free capacity, lowest index).  The fit test
        prefers a clean gang shape — ``w`` empty nodes plus a best-fit
        remainder hole, computed as cached segment reductions over the
        overlay's node columns — and falls back to a scattered
        multi-piece fill wherever the aggregate free capacity suffices
        (legal under the device-proxy; the locality loss is what the
        fragmentation metric and defrag pass track).  Only when no
        cluster fits the gang even scattered does the job shrink down
        the splice-compatible ladder into the best healthy cluster
        (preempted below its floor).

        This per-job loop is the placement ORACLE: the batched core
        (``_place_nodes_batched``, the production path) must reproduce
        its plans byte-for-byte — the digest equivalence gates pin the
        two against each other on every bench trace.  Both decide paths
        dispatch here on identically-derived inputs, so span plans — and
        therefore failure blast radii — cannot drift between the scalar
        oracle and the vectorized path."""
        n = galloc.size
        idx = np.arange(n)
        order_p = np.lexsort((idx, -galloc, -prio))
        any_drain = bool(drain.any())
        no_stay = np.zeros(n, dtype=bool)
        if any_drain:
            on_draining = (
                (jcl >= 0) & running & (galloc > 0) & drain[np.maximum(jcl, 0)]
            )
            for i in np.flatnonzero(on_draining):
                no_stay[i] = self._proactive_move(active[i])

        ov = nm.overlay()
        has_span, span_k, span_tot = nm.row_state(rows)
        placed = np.full(n, -1, dtype=np.int64)
        migrate = np.zeros(n, dtype=bool)
        # trivially kept: same cluster, same world size, allowed to stay
        # -> the physical span is already correct, nothing to do
        kept = (
            (galloc > 0)
            & has_span
            & (span_k == jcl)
            & (span_tot == galloc)
            & ~no_stay
        )
        placed[kept] = jcl[kept]
        for i in np.flatnonzero(has_span & ~kept):
            ov.release_row(int(rows[i]))

        changed = order_p[(galloc[order_p] > 0) & ~kept[order_p]]
        fresh: dict = {}  # job index -> its entry in ov.assigns
        # phase A (mirrors the stay-put pass): resized/restored jobs stay
        # on their cluster when a gang fit exists there
        staying = np.zeros(n, dtype=bool)
        for i in changed:
            k = int(jcl[i])
            if (
                k >= 0
                and not no_stay[i]
                and (ov.feasible(k, int(galloc[i])) or ov.cfree[k] >= galloc[i])
            ):
                ov.fit_any(int(rows[i]), k, int(galloc[i]))
                placed[i] = k
                staying[i] = True
                fresh[int(i)] = len(ov.assigns) - 1
        # phase B: residual pool, cluster preferences unchanged from the
        # cluster-granular path but with gang feasibility as the fit test
        for i in changed:
            if staying[i]:
                continue
            g = int(galloc[i])
            feas = ov.feasible_vec(g)
            if not feas.any():
                # no clean gang shape anywhere: scattered placement is
                # still legal wherever the aggregate free capacity fits
                feas = ov.cfree >= g
            if feas.any():
                pool = feas
                if any_drain:
                    nd = feas & ~drain
                    if nd.any():
                        pool = nd
                if running[i] and jreg[i] >= 0:
                    same = pool & (creg == jreg[i])
                    if same.any():
                        pool = same
                k = int(np.argmax(np.where(pool, ov.cfree, -1)))
            else:
                # no cluster hosts the full gang even scattered: shrink
                # down the splice ladder into the best healthy cluster
                if any_drain and not drain.all():
                    k = int(np.argmax(np.where(~drain, ov.cfree, -1)))
                    v = gang_down(int(min(g, ov.cfree[k])), int(demand[i]))
                    if v < int(min_g[i]):
                        k = int(np.argmax(ov.cfree))
                        v = gang_down(int(min(g, ov.cfree[k])), int(demand[i]))
                else:
                    k = int(np.argmax(ov.cfree))
                    v = gang_down(int(min(g, ov.cfree[k])), int(demand[i]))
                if v < int(min_g[i]):
                    v = 0
                if v == 0:
                    galloc[i] = 0
                    if running[i]:
                        preempt[i] = True
                    continue
                galloc[i] = v
                g = v
            ov.fit_any(int(rows[i]), k, g)
            placed[i] = k
            fresh[int(i)] = len(ov.assigns) - 1
            if running[i] and has_cluster[i] and placed[i] != jcl[i]:
                migrate[i] = True
        # phase C: work conservation — grow placed jobs back up their
        # splice ladder into capacity left idle by gang rounding and
        # shrink-to-fit, highest priority first.  Growth stays on the
        # job's cluster (no migration; the allocation change is charged
        # as a resize like any other).
        left = int(ov.cfree.sum())
        if left > 0:
            for i in order_p:
                if left <= 0:
                    break
                k = int(placed[i])
                if k >= 0:
                    # grow a placed job toward its demand
                    if galloc[i] >= demand[i]:
                        continue
                    rem = int(ov.cfree[k])
                    if rem <= 0:
                        continue
                    g = int(galloc[i])
                    hi_v = min(int(demand[i]), g + rem)
                    lad = gang_values(int(demand[i]), g + 1, hi_v)
                    if not lad:
                        continue
                    v = int(lad[0])
                    ii = int(i)
                    if ii in fresh:
                        ov.undo(fresh[ii])
                    else:
                        ov.release_row(int(rows[i]))
                    ov.fit_any(int(rows[i]), k, v)
                    fresh[ii] = len(ov.assigns) - 1
                    galloc[i] = v
                    left -= v - g
                    continue
                # admit a waiting job at the largest compatible gang the
                # best cluster still holds (rescues grants the ledger's
                # gang rounding zeroed below the job's floor)
                d_i, m_i = int(demand[i]), int(min_g[i])
                if any_drain and not drain.all():
                    k = int(np.argmax(np.where(~drain, ov.cfree, -1)))
                    v = gang_down(int(min(d_i, ov.cfree[k])), d_i)
                    if v < m_i:
                        k = int(np.argmax(ov.cfree))
                        v = gang_down(int(min(d_i, ov.cfree[k])), d_i)
                else:
                    k = int(np.argmax(ov.cfree))
                    v = gang_down(int(min(d_i, ov.cfree[k])), d_i)
                if v <= 0 or v < m_i:
                    continue
                ov.fit_any(int(rows[i]), k, v)
                fresh[int(i)] = len(ov.assigns) - 1
                placed[i] = k
                galloc[i] = v
                left -= v
                preempt[i] = False
                if running[i] and has_cluster[i] and k != int(jcl[i]):
                    migrate[i] = True
        assigns = [a for a in ov.assigns if a is not None]
        return galloc, placed, preempt, migrate, (nm, ov.released, assigns)

    def _place_nodes_batched(
        self,
        nm,
        active: List[Job],
        rows: np.ndarray,
        galloc: np.ndarray,
        min_g: np.ndarray,
        demand: np.ndarray,
        prio: np.ndarray,
        running: np.ndarray,
        preempt: np.ndarray,
        jcl: np.ndarray,
        has_cluster: np.ndarray,
        jreg: np.ndarray,
        creg: np.ndarray,
        drain: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, tuple]:
        """Batched node placement: byte-identical plans to the per-job
        loop oracle (``_place_nodes_loop``), derived as array passes.

        Three exact reductions carry the phases:

        * Phase A — the oracle keeps a changed job on its own cluster
          when ``feasible(k, g) or cfree[k] >= g``; a feasible gang
          always fits the aggregate, so the test is just
          ``cfree[k] >= g`` and the per-cluster admissions are the same
          cumsum greedy (``_greedy_take``) the cluster-granular stay-put
          pass uses.  The winning fits replay in changed order through
          ``fit_batch``, which collapses runs of identical whole-node
          shapes into slices.
        * Phase B keeps the oracle's loop shape (its trip count is
          bounded by jobs holding GPUs, not queue depth), but the pool
          pick is ``PlacementOverlay.pick_cluster``, which answers the
          oracle's ``argmax(where(pool, cfree, -1))`` (argmax ties
          break low) by walking a lazily-validated max-heap of
          ``(-cfree, k)`` entries — the heap order *is* the argmax
          order, so the first gang-feasible valid head is the answer —
          with a K-cluster scan only for drain/region-filtered picks.
        * Phase C — a candidate acts only when a watched capacity
          counter reaches its precomputed threshold: growth of a placed
          job fires iff its cluster's free count covers the next rung of
          its divisor ladder, admission of a queued job fires iff the
          fleet-wide max cluster free covers its smallest admissible
          gang (``floor_gang``).  Phase C only consumes capacity, so the
          counters are non-increasing between visits: a chunked scan
          against chunk-start counters passes a superset of the oracle's
          actors, and each hit re-runs the oracle's own body, which
          rejects exactly the stale ones.  The 1M-job scan thus touches
          Python only for jobs that actually grow or admit."""
        n = galloc.size
        idx = np.arange(n)
        order_p = np.lexsort((idx, -galloc, -prio))
        any_drain = bool(drain.any())
        no_stay = np.zeros(n, dtype=bool)
        if any_drain:
            on_draining = (
                (jcl >= 0) & running & (galloc > 0) & drain[np.maximum(jcl, 0)]
            )
            for i in np.flatnonzero(on_draining):
                no_stay[i] = self._proactive_move(active[i])

        ov = nm.overlay()
        has_span, span_k, span_tot = nm.row_state(rows)
        placed = np.full(n, -1, dtype=np.int64)
        migrate = np.zeros(n, dtype=bool)
        kept = (
            (galloc > 0)
            & has_span
            & (span_k == jcl)
            & (span_tot == galloc)
            & ~no_stay
        )
        placed[kept] = jcl[kept]
        ov.release_rows(rows[has_span & ~kept])

        changed = order_p[(galloc[order_p] > 0) & ~kept[order_p]]
        fresh: dict = {}  # job index -> its entry in ov.assigns
        # phase A: per-cluster cumsum greedy over the changed jobs that
        # may stay put, then one fit_batch replay in changed order
        with self.prof.span("phase_a"):
            staying = np.zeros(n, dtype=bool)
            elig = changed[(jcl[changed] >= 0) & ~no_stay[changed]]
            if elig.size:
                for k in np.unique(jcl[elig]):
                    sel = elig[jcl[elig] == k]
                    g, _ = _greedy_take(
                        galloc[sel], galloc[sel], int(ov.cfree[k]), partial=False
                    )
                    staying[sel[g > 0]] = True
                st = changed[staying[changed]]
                if st.size:
                    placed[st] = jcl[st]
                    base = len(ov.assigns)
                    ov.fit_batch(rows[st], jcl[st], galloc[st])
                    for t, i in enumerate(st):
                        fresh[int(i)] = base + t
        # phase B: residual pool picks — the oracle loop's pool filters,
        # but each pick is the overlay's heap-walk pick_cluster instead
        # of K-wide vector math, and the per-job columns are
        # pre-gathered to python lists so the loop never touches numpy
        # scalars
        with self.prof.span("phase_b"):
            drain_l = drain.tolist() if any_drain else None
            all_drain = bool(drain.all()) if any_drain else False
            creg_l = creg.tolist()
            ch_l = changed.tolist()
            stay_l = staying[changed].tolist()
            g_l = galloc[changed].tolist()
            run_l = running[changed].tolist()
            jreg_l = jreg[changed].tolist()
            rows_l = rows[changed].tolist()
            jcl_l = jcl[changed].tolist()
            hasc_l = has_cluster[changed].tolist()
            for t, i in enumerate(ch_l):
                if stay_l[t]:
                    continue
                g = g_l[t]
                want = jreg_l[t] if run_l[t] and jreg_l[t] >= 0 else -1
                k = ov.pick_cluster(g, drain_l, want, creg_l)
                if k < 0:
                    if any_drain and not all_drain:
                        k = ov.best_healthy(drain_l)
                        v = gang_down(min(g, ov._cfree[k]), int(demand[i]))
                        if v < int(min_g[i]):
                            k = ov.best_cluster()
                            v = gang_down(min(g, ov._cfree[k]), int(demand[i]))
                    else:
                        k = ov.best_cluster()
                        v = gang_down(min(g, ov._cfree[k]), int(demand[i]))
                    if v < int(min_g[i]):
                        v = 0
                    if v == 0:
                        galloc[i] = 0
                        if run_l[t]:
                            preempt[i] = True
                        continue
                    galloc[i] = v
                    g = v
                ov.fit_any(rows_l[t], k, g)
                placed[i] = k
                fresh[i] = len(ov.assigns) - 1
                if run_l[t] and hasc_l[t] and k != jcl_l[t]:
                    migrate[i] = True
        # phase C: work conservation as a threshold scan (see docstring)
        with self.prof.span("phase_c"):
            left = int(ov.cfree.sum())
            if left > 0:
                cand = order_p[
                    (placed[order_p] < 0) | (galloc[order_p] < demand[order_p])
                ]
                never = np.int64(2**62)
                thr = np.full(cand.size, never)
                wk = np.full(cand.size, -1, np.int64)
                grow = placed[cand] >= 0
                gi = cand[grow]
                if gi.size:
                    wk[grow] = placed[gi]
                    gg = galloc[gi]
                    dd = demand[gi]
                    delta = np.empty(gi.size, np.int64)
                    for d in np.unique(dd):
                        m = dd == d
                        divs = np.asarray(splice_divisors(int(d)), np.int64)
                        # next compatible world size above the current grant
                        delta[m] = (
                            divs[np.searchsorted(divs, gg[m], side="right")]
                            - gg[m]
                        )
                    thr[grow] = delta
                ai = cand[~grow]
                if ai.size:
                    dd = demand[ai]
                    mm = np.maximum(1, min_g[ai])
                    base_m = int(mm.max()) + 1
                    uk, inv = np.unique(dd * base_m + mm, return_inverse=True)
                    ut = np.fromiter(
                        (
                            floor_gang(int(u) // base_m, int(u) % base_m)
                            for u in uk
                        ),
                        np.int64,
                        uk.size,
                    )
                    tau = ut[inv]
                    thr[~grow] = np.where(tau > 0, tau, never)
                ch = 4096
                pos = 0
                while pos < cand.size and left > 0:
                    lim = min(pos + ch, cand.size)
                    cw = wk[pos:lim]
                    m_free = int(ov.cfree.max())
                    cur = np.where(cw >= 0, ov.cfree[np.maximum(cw, 0)], m_free)
                    for i in cand[pos:lim][cur >= thr[pos:lim]]:
                        if left <= 0:
                            break
                        k = int(placed[i])
                        if k >= 0:
                            if galloc[i] >= demand[i]:
                                continue
                            rem = int(ov.cfree[k])
                            if rem <= 0:
                                continue
                            g = int(galloc[i])
                            hi_v = min(int(demand[i]), g + rem)
                            lad = gang_values(int(demand[i]), g + 1, hi_v)
                            if not lad:
                                continue
                            v = int(lad[0])
                            ii = int(i)
                            if ii in fresh:
                                ov.undo(fresh[ii])
                            else:
                                ov.release_row(int(rows[i]))
                            ov.fit_any(int(rows[i]), k, v)
                            fresh[ii] = len(ov.assigns) - 1
                            galloc[i] = v
                            left -= v - g
                            continue
                        d_i, m_i = int(demand[i]), int(min_g[i])
                        if any_drain and not drain.all():
                            k = int(np.argmax(np.where(~drain, ov.cfree, -1)))
                            v = gang_down(int(min(d_i, ov.cfree[k])), d_i)
                            if v < m_i:
                                k = int(np.argmax(ov.cfree))
                                v = gang_down(int(min(d_i, ov.cfree[k])), d_i)
                        else:
                            k = int(np.argmax(ov.cfree))
                            v = gang_down(int(min(d_i, ov.cfree[k])), d_i)
                        if v <= 0 or v < m_i:
                            continue
                        ov.fit_any(int(rows[i]), k, v)
                        fresh[int(i)] = len(ov.assigns) - 1
                        placed[i] = k
                        galloc[i] = v
                        left -= v
                        preempt[i] = False
                        if running[i] and has_cluster[i] and k != int(jcl[i]):
                            migrate[i] = True
                    pos = lim
        assigns = [a for a in ov.assigns if a is not None]
        return galloc, placed, preempt, migrate, (nm, ov.released, assigns)

    def _proactive_move(self, j: Job) -> bool:
        """Should a running job evacuate its draining cluster now?

        Moving costs one migration's downtime (intra price as the lower
        bound — the destination is only chosen afterwards).  Staying
        risks the domain's deadline: the unsnapshotted progress is lost
        and the job pays a restore anyway.  Evacuate when the move is
        cheaper than the work it saves."""
        lost = max(0.0, j.progress - j.snap_progress) * j.ideal_seconds
        if self.cost_model is None:
            return lost > 0.0
        cb = j.checkpoint_bytes
        at_risk = lost + self.cost_model.restore_seconds(cb)
        return self.cost_model.migrate_seconds(cb) < at_risk

    # ================= scalar reference oracle ===========================
    def _decide_reference(
        self, now: float, active: List[Job], fleet: Fleet
    ) -> Decision:
        """Pure-Python oracle with semantics identical to the vectorized
        path (property-tested equivalence); kept for auditability and as
        the ground truth the numpy passes are checked against."""
        n = len(active)
        interval = self._interval()
        total = fleet.capacity()
        need = [self._required(now, j) for j in active]
        head = [
            active[i].account.headroom(now)
            if TIERS[active[i].tier].gpu_fraction > 0
            else float("inf")
            for i in range(n)
        ]
        vcost = [self._victim_cost(j) for j in active]
        restart = [self._restart_cost(j) for j in active]
        running = [j.allocated > 0 for j in active]

        # fairness aging, same per-tier formula as the vectorized path
        threshold = self.aging_threshold_intervals * interval
        wait = [now - j.queued_since for j in active]
        rate = [self._aging_by_tier[j.tier] for j in active]
        aged = [
            rate[i] > 0.0
            and not running[i]
            and TIERS[active[i].tier].gpu_fraction > 0
            and wait[i] > threshold
            for i in range(n)
        ]
        score = [
            vcost[i]
            if running[i]
            else (rate[i] * (wait[i] - threshold) if aged[i] else 0.0)
            for i in range(n)
        ]

        order_a = sorted(
            range(n),
            key=lambda i: (
                -TIERS[active[i].tier].preempt_priority,
                0 if active[i].service else 1,
                0 if (running[i] or aged[i]) else 1,
                -score[i],
                active[i].arrival,
                i,
            ),
        )
        galloc = [0] * n
        used = 0

        # 1. guaranteed demands, all-or-nothing
        for i in order_a:
            if need[i] > 0 and total - used >= need[i]:
                galloc[i] = need[i]
                used += need[i]

        # 1b. shrink-before-queue (restart-cost gated; curved jobs price
        #     the interval's buy at the shrunk operating point, like the
        #     vectorized pass)
        for i in order_a:
            if galloc[i] > 0 or need[i] == 0:
                continue
            j = active[i]
            if self.curve_aware and j.knee_gpus > 0:
                worth = interval * (need[i] / j.demand_gpus)
            else:
                worth = interval
            if head[i] <= 0.1 or restart[i] >= worth:
                continue
            give = min(j.demand_gpus, total - used)
            if give >= j.min_gpus:
                galloc[i] = give
                used += give

        # 2. top up to full demand
        for i in order_a:
            if galloc[i] == 0 and need[i] > 0:
                continue  # not admitted this interval
            give = min(active[i].demand_gpus - galloc[i], total - used)
            if galloc[i] == 0 and give < active[i].min_gpus:
                continue  # below the ZeRO floor: keep it queued
            if give > 0:
                galloc[i] += give
                used += give

        # 3. slope-gated opportunistic expansion: the scalar mirror of the
        #    vectorized water-filling pass (see _decide_vectorized pass 3
        #    for the chunking/pricing rationale)
        nm = fleet.node_map
        slope_ids: set = set()
        if total - used > 0.1 * total:
            cm = self.cost_model
            chunks = []  # (d_a, d_b, slope_b, gate_a, gate_b, is_curved)
            for i in range(n):
                j = active[i]
                extra = int(j.demand_gpus * (self.expand_factor - 1))
                target = galloc[i] + extra
                is_curved = self.curve_aware and j.knee_gpus > 0
                if is_curved:
                    end_a = min(max(j.knee_gpus, galloc[i]), target)
                    if nm is not None:
                        end_a = max(end_a - end_a % j.demand_gpus, galloc[i])
                else:
                    end_a = target
                d_a = end_a - galloc[i]
                d_b = target - end_a
                slope_b = j.sat_slope * interval
                if cm is None:
                    gate_a = gate_b = True
                else:
                    free = not running[i] or galloc[i] != j.allocated
                    rs = cm.resize_seconds(j.checkpoint_bytes)
                    gate_a = (
                        free or rs * float(galloc[i] + d_a) < float(d_a) * interval
                    )
                    if d_a > 0:
                        gate_b = gate_a and (free or slope_b > rs)
                    else:
                        gate_b = (
                            free
                            or rs * float(galloc[i] + d_b) < slope_b * float(d_b)
                        )
                chunks.append((d_a, d_b, slope_b, gate_a, gate_b, is_curved))
            order_s = sorted(
                range(n),
                key=lambda i: (TIERS[active[i].tier].scaleup_priority, i),
            )
            grant_a = [0] * n
            grant_b = [0] * n
            for i in order_s:
                d_a, _, _, gate_a, _, _ = chunks[i]
                if galloc[i] == 0 or active[i].service:
                    continue  # serving never expands past its target
                if d_a <= 0 or not gate_a:
                    continue
                give = min(d_a, total - used)
                if give > 0:
                    grant_a[i] = give
                    galloc[i] += give
                    used += give
            order_b = sorted(
                range(n),
                key=lambda i: (
                    -chunks[i][2],
                    TIERS[active[i].tier].scaleup_priority,
                    i,
                ),
            )
            for i in order_b:
                d_a, d_b, _, _, gate_b, _ = chunks[i]
                if galloc[i] - grant_a[i] == 0 or active[i].service:
                    continue
                if d_b <= 0 or not gate_b:
                    continue
                if d_a > 0 and grant_a[i] != d_a:
                    continue  # concavity: cheap chunk fills first
                give = min(d_b, total - used)
                if give > 0:
                    grant_b[i] = give
                    galloc[i] += give
                    used += give
            for i in range(n):
                if chunks[i][5] and grant_a[i] + grant_b[i] > 0:
                    slope_ids.add(active[i].id)

        # 3b. gang/splice rounding + ladder top-up, same point and same
        #     routine as the vectorized path
        if nm is not None:
            for i in range(n):
                galloc[i] = gang_down(galloc[i], active[i].demand_gpus)
            arr = np.asarray(galloc, np.int64)
            _gang_topup(
                arr,
                np.fromiter((j.demand_gpus for j in active), np.int64, n),
                np.fromiter(
                    (TIERS[j.tier].preempt_priority for j in active), np.int64, n
                ),
                int(total - arr.sum()),
            )
            galloc = [int(v) for v in arr]

        # 4. splice floor -> preempt
        preempted = set()
        for i in range(n):
            if 0 < galloc[i] < active[i].min_gpus:
                if running[i]:
                    preempted.add(i)
                galloc[i] = 0

        # 5. placement (node-granular when the fleet carries a NodeMap:
        # the reference path derives the same inputs per job in Python
        # and runs the same placement core, so span plans cannot drift)
        slope_expanded = tuple(sorted(slope_ids)) if slope_ids else None
        if nm is not None:
            return self._place_reference_nodes(
                active, fleet, nm, galloc, preempted, slope_expanded
            )
        clusters = fleet.clusters()
        free = {c.id: c.capacity() for c in clusters}
        cdrain = {c.id: c.draining for c in clusters}
        cluster_region = {c.id: fleet.region_of(c.id) for c in clusters}
        order_ids = {c.id: k for k, c in enumerate(clusters)}
        order_p = sorted(
            range(n),
            key=lambda i: (
                -TIERS[active[i].tier].preempt_priority,
                -galloc[i],
                i,
            ),
        )
        placements: Dict[int, str] = {}
        for i in order_p:
            j = active[i]
            if galloc[i] > 0 and j.cluster in free and free[j.cluster] >= galloc[i]:
                # a running job on a draining cluster evacuates instead of
                # staying put when the move saves more work than it costs
                if running[i] and cdrain[j.cluster] and self._proactive_move(j):
                    continue
                placements[i] = j.cluster
                free[j.cluster] -= galloc[i]
        migrations = set()
        for i in order_p:
            j = active[i]
            g = galloc[i]
            if g == 0 or i in placements:
                continue
            fitting = [c for c in free if free[c] >= g]
            if fitting:
                healthy = [c for c in fitting if not cdrain[c]]
                if healthy:
                    fitting = healthy
                region = cluster_region.get(j.cluster)
                if running[i] and region is not None:
                    same = [c for c in fitting if cluster_region[c] == region]
                    if same:
                        fitting = same
                cid = min(fitting, key=lambda c: (-free[c], order_ids[c]))
            else:
                healthy = [c for c in free if not cdrain[c]]
                cid = (
                    min(healthy, key=lambda c: (-free[c], order_ids[c]))
                    if healthy
                    else None
                )
                if cid is None or free[cid] < j.min_gpus:
                    cid = min(free, key=lambda c: (-free[c], order_ids[c]))
                hole = free[cid]
                if hole < j.min_gpus:
                    galloc[i] = 0
                    if running[i]:
                        preempted.add(i)
                    continue
                g = hole
                galloc[i] = g
            placements[i] = cid
            free[cid] -= g
            if running[i] and j.cluster is not None and cid != j.cluster:
                migrations.add(i)

        final = {active[i].id: (galloc[i], placements.get(i)) for i in range(n)}
        return Decision(
            alloc=final,
            preemptions=sorted(active[i].id for i in preempted),
            migrations=sorted(active[i].id for i in migrations),
            slope_expanded=slope_expanded,
        )

    def _place_reference_nodes(
        self,
        active: List[Job],
        fleet: Fleet,
        nm,
        galloc: List[int],
        preempted: set,
        slope_expanded: Optional[Tuple[str, ...]] = None,
    ) -> Decision:
        """Reference-path entry to node placement: gather the per-job
        state as the scalar loops see it, then run the shared placement
        core on it."""
        n = len(active)
        clusters = fleet.clusters()
        cid_index = {c.id: k for k, c in enumerate(clusters)}
        regions = {r.id: k for k, r in enumerate(fleet.regions)}
        creg = np.fromiter(
            (regions[fleet.region_of(c.id)] for c in clusters),
            np.int64,
            len(clusters),
        )
        jcl = np.fromiter((cid_index.get(j.cluster, -1) for j in active), np.int64, n)
        has_cluster = np.fromiter((j.cluster is not None for j in active), bool, n)
        jreg = np.where(jcl >= 0, creg[np.maximum(jcl, 0)], -1)
        drain = np.fromiter((c.draining for c in clusters), bool, len(clusters))
        rows = np.fromiter((j.node_slot for j in active), np.int64, n)
        g = np.asarray(galloc, np.int64)
        min_g = np.fromiter((j.min_gpus for j in active), np.int64, n)
        demand = np.fromiter((j.demand_gpus for j in active), np.int64, n)
        running = np.fromiter((j.allocated > 0 for j in active), bool, n)
        prio = np.fromiter(
            (TIERS[j.tier].preempt_priority for j in active), np.int64, n
        )
        preempt = np.zeros(n, dtype=bool)
        for i in preempted:
            preempt[i] = True
        g, placed, preempt, migrate, node_plan = self._place_nodes(
            nm,
            active,
            rows,
            g,
            min_g,
            demand,
            prio,
            running,
            preempt,
            jcl,
            has_cluster,
            jreg,
            creg,
            drain,
        )
        final: Dict[str, Tuple[int, Optional[str]]] = {}
        for i in range(n):
            cid = clusters[placed[i]].id if placed[i] >= 0 else None
            final[active[i].id] = (int(g[i]), cid)
        return Decision(
            alloc=final,
            preemptions=sorted(active[i].id for i in np.flatnonzero(preempt)),
            migrations=sorted(active[i].id for i in np.flatnonzero(migrate)),
            node_plan=node_plan,
            slope_expanded=slope_expanded,
        )
