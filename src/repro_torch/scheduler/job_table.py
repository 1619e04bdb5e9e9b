"""JobTable: a simulator-owned struct-of-arrays for per-job state.

``FleetSLAAccounts`` removed the per-job SLA queries from the decide
path; the remaining floor was the per-job *attribute gather* — at every
tick ``ElasticPolicy._decide_vectorized`` rebuilt an ``(n, 8)`` base
array by touching eight attributes of every active ``Job`` object (~60%
of decide time at 1M jobs), and the simulator re-materialized its own
``_arrival``/``_demand``/``_ideal`` arrays from the same objects.

``JobTable`` removes that floor the same way the SLA ledger did: every
numeric per-job field lives in a shared numpy column (one row per slot,
grown by doubling, freed rows reused), and the ``Job`` object becomes a
thin per-slot view — ``JobTable.adopt`` copies a plain ``Job``'s state
into a fresh row and flips the instance's class to ``TableJob``, whose
property accessors read and write the columns in place.  The decide path
then takes column *slices* (``table.demand_gpus[slots]``) with zero
per-job Python work, the simulator's event loop reads/writes the same
columns the policy and ``_apply`` see (no resync loops), and completed
jobs ``detach``: their final state is copied back onto the instance, the
class flips back to ``Job``, and the row returns to the free list.

Column fields (all shared with the policy's vectorized decide path):
``demand_gpus``, ``min_gpus``, ``allocated``, ``arrival``,
``checkpoint_bytes``, ``restore_debt``, ``tier_code``, ``queued_since``,
``ever_ran``, ``progress``, ``snap_progress``, ``snap_time``,
``done_at`` (NaN = not done), ``downtime_until``, ``downtime_seconds``,
``gpu_hours``, ``splice_overhead``, ``knee_gpus``/``sat_slope`` (the
concave scaling curve, ``scheduler/curves.py``), ``ideal`` and
``cluster_idx`` (an index into the owning fleet's cluster order, -1 =
unplaced).  Identity
(``id``, ``tier``), the SLA account object and the rare event counters
stay on the instance.

When the table carries an SLA ledger (``sla=``), ``adopt`` swaps a
job's ``FleetSlotAccount`` view for a ``_TableSlotAccount`` that mirrors
its lazily-registered ledger slot into the ``sla_slot`` column on every
``ensure_slot`` — so the policy reads the whole fleet's headroom with
one ``headroom_all(now, table.sla_slot[slots], ...)`` call and no
account-object gather.  Jobs with scalar or foreign-ledger accounts are
flagged ``sla_view=False`` and fall back per job, exactly like the
mixed-ledger fallback in ``policy._shared_ledger``.

``JobView`` is the zero-gather handle the simulator passes to
``ElasticPolicy.decide``: a sequence of the adopted ``Job`` objects plus
the array of their slots, so the policy never walks the objects at all.
Hand-built scalar ``Job`` lists keep the per-job build path, and
mixed/foreign-table lists are detected and fall back, mirroring
``_shared_ledger``.

A copy of ``repro.scheduler.job_table``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.core.sla import TIERS, FleetSlotAccount
from repro_torch.scheduler.types import Job

# tier name <-> small-int code, shared by the table, the simulator and
# the policy's lookup tables (all enumerate TIERS in dict order)
TIER_CODE = {name: i for i, name in enumerate(TIERS)}
TIER_NAMES = list(TIERS)

# (column name, dtype, fill value for freed rows).  ``arrival`` resets to
# +inf and ``done_at`` to NaN so a stale freed row can never look active.
_COLUMNS = (
    ("demand_gpus", np.int64, 0),
    ("min_gpus", np.int64, 0),
    ("allocated", np.int64, 0),
    ("arrival", np.float64, np.inf),
    ("checkpoint_bytes", np.int64, 0),
    ("restore_debt", np.float64, 0.0),
    ("tier_code", np.int64, 0),
    ("queued_since", np.float64, 0.0),
    ("ever_ran", np.bool_, False),
    ("service", np.bool_, False),
    ("progress", np.float64, 0.0),
    ("snap_progress", np.float64, 0.0),
    ("snap_time", np.float64, 0.0),
    ("done_at", np.float64, np.nan),
    ("downtime_until", np.float64, 0.0),
    ("downtime_seconds", np.float64, 0.0),
    ("gpu_hours", np.float64, 0.0),
    ("splice_overhead", np.float64, 0.0),
    ("knee_gpus", np.int64, 0),
    ("sat_slope", np.float64, 1.0),
    ("ideal", np.float64, 0.0),
    ("cluster_idx", np.int64, -1),
    ("sla_slot", np.int64, -1),
    ("sla_view", np.bool_, False),
)

# Job fields whose storage moves into the table on adopt (and back out on
# detach).  ``cluster`` maps through the table's cluster registry;
# ``done_at`` maps None <-> NaN.
_SCALAR_FIELDS = (
    "demand_gpus",
    "min_gpus",
    "allocated",
    "arrival",
    "checkpoint_bytes",
    "restore_debt",
    "queued_since",
    "ever_ran",
    "service",
    "progress",
    "snap_progress",
    "snap_time",
    "downtime_until",
    "downtime_seconds",
    "gpu_hours",
    "splice_overhead",
    "knee_gpus",
    "sat_slope",
)


class JobTable:
    """Struct-of-arrays job state owned by a simulator/executor fleet.

    Mirrors the ``FleetSLAAccounts`` design: slots registered on adopt,
    released (and the row reused) on detach, columns grown by doubling.
    ``objs``/``ids`` keep the adopted ``Job`` objects and their string
    ids per slot so the policy can emit ``Decision`` entries without
    walking the objects.
    """

    def __init__(
        self,
        clusters: Optional[Sequence[str]] = None,
        sla=None,
        capacity: int = 64,
    ):
        self._cap = max(1, int(capacity))
        self._n = 0  # high-water slot mark
        self._free: List[int] = []
        for name, dtype, fill in _COLUMNS:
            setattr(self, name, np.full(self._cap, fill, dtype=dtype))
        self.ids = np.full(self._cap, None, dtype=object)
        self.objs = np.full(self._cap, None, dtype=object)
        # cluster registry: id <-> small-int code.  Built from the owning
        # fleet's cluster order so ``cluster_idx`` doubles as an index
        # into ``fleet.clusters()``; unknown ids register lazily past it.
        self._cluster_ids: List[str] = []
        self._cluster_code = {}
        for cid in clusters or ():
            self.cluster_code(cid)
        self.sla = sla  # FleetSLAAccounts the adopted accounts live in
        # set by a driver that binds the column arrays into its event
        # loop (the vectorized simulator): growth would silently replace
        # the bound arrays, so it is forbidden while pinned
        self.pinned = False

    # ------------------------------------------------------------- slots
    @property
    def slots_in_use(self) -> int:
        return self._n - len(self._free)

    @property
    def capacity(self) -> int:
        return self._cap

    def cluster_code(self, cluster_id: Optional[str]) -> int:
        if cluster_id is None:
            return -1
        code = self._cluster_code.get(cluster_id)
        if code is None:
            code = len(self._cluster_ids)
            self._cluster_ids.append(cluster_id)
            self._cluster_code[cluster_id] = code
        return code

    def cluster_id(self, code: int) -> Optional[str]:
        return self._cluster_ids[code] if code >= 0 else None

    def matches_clusters(self, cluster_ids: Sequence[str]) -> bool:
        """True when this table's registry starts with ``cluster_ids`` in
        order — i.e. ``cluster_idx`` values below ``len(cluster_ids)``
        index that cluster list directly (the policy's placement fast
        path requires it)."""
        k = len(cluster_ids)
        ids = self._cluster_ids
        return len(ids) >= k and ids[:k] == list(cluster_ids)

    def _grow(self) -> None:
        assert not self.pinned, (
            "JobTable growth while its columns are bound into an event "
            "loop would decouple the bound views from the live arrays; "
            "size the table for the trace up front"
        )
        cap = self._cap * 2
        for name, dtype, fill in _COLUMNS:
            old = getattr(self, name)
            out = np.full(cap, fill, dtype=dtype)
            out[: self._cap] = old
            setattr(self, name, out)
        for name in ("ids", "objs"):
            old = getattr(self, name)
            out = np.full(cap, None, dtype=object)
            out[: self._cap] = old
            setattr(self, name, out)
        self._cap = cap

    def _register(self) -> int:
        if self._free:
            return self._free.pop()
        if self._n == self._cap:
            self._grow()
        slot = self._n
        self._n += 1
        return slot

    def _reset_slot(self, slot: int) -> None:
        for name, _, fill in _COLUMNS:
            getattr(self, name)[slot] = fill
        self.ids[slot] = None
        self.objs[slot] = None

    # ----------------------------------------------------- adopt / detach
    def adopt(self, job: Job) -> int:
        """Move ``job``'s numeric state into a table row and flip the
        instance to a ``TableJob`` view on it.  Returns the slot."""
        assert type(job) is Job, f"cannot adopt {type(job).__name__}"
        slot = self._register()
        for f in _SCALAR_FIELDS:
            getattr(self, f)[slot] = getattr(job, f)
        self.tier_code[slot] = TIER_CODE[job.tier]
        self.done_at[slot] = np.nan if job.done_at is None else job.done_at
        self.cluster_idx[slot] = self.cluster_code(job.cluster)
        self.ideal[slot] = job.gpu_hours * 3600.0 / job.demand_gpus
        self.ids[slot] = job.id
        self.objs[slot] = job
        acc = job.account
        if (
            self.sla is not None
            and isinstance(acc, FleetSlotAccount)
            and acc.ledger is self.sla
        ):
            job.account = _TableSlotAccount(acc, self, slot)
            self.sla_slot[slot] = acc.slot
            self.sla_view[slot] = True
        # drop the instance storage the properties now shadow, then flip
        d = job.__dict__
        for f in _SCALAR_FIELDS + ("done_at", "cluster"):
            d.pop(f, None)
        d["_table"] = self
        d["_slot"] = slot
        job.__class__ = TableJob
        return slot

    def detach(self, job: "TableJob") -> None:
        """Copy the row's final state back onto the instance, flip it
        back to a plain ``Job`` and free the slot for reuse."""
        assert isinstance(job, TableJob) and job._table is self
        slot = job._slot
        values = {f: getattr(job, f) for f in _SCALAR_FIELDS}
        values["done_at"] = job.done_at
        values["cluster"] = job.cluster
        acc = job.account
        if isinstance(acc, _TableSlotAccount):
            plain = FleetSlotAccount.__new__(FleetSlotAccount)
            plain.ledger = acc.ledger
            plain.tier = acc.tier
            plain.demand = acc.demand
            plain.slot = acc.slot
            values["account"] = plain
        d = job.__dict__
        d.pop("_table", None)
        d.pop("_slot", None)
        job.__class__ = Job
        d.update(values)
        self._reset_slot(slot)
        self._free.append(slot)

    def adopt_batch(self, jobs: Sequence[Job]) -> np.ndarray:
        """``adopt`` for a whole trace at once (the simulator's
        construction path): per-field column fills instead of per-job
        scalar writes.  Every job must be a plain ``Job`` (the caller
        checks); returns the slot array, in job order."""
        m = len(jobs)
        slots = np.fromiter((self._register() for _ in range(m)), np.int64, m)
        for f in _SCALAR_FIELDS:
            getattr(self, f)[slots] = [getattr(j, f) for j in jobs]
        self.tier_code[slots] = [TIER_CODE[j.tier] for j in jobs]
        self.done_at[slots] = [np.nan if j.done_at is None else j.done_at for j in jobs]
        self.cluster_idx[slots] = [self.cluster_code(j.cluster) for j in jobs]
        self.ideal[slots] = self.gpu_hours[slots] * 3600.0 / self.demand_gpus[slots]
        self.ids[slots] = [j.id for j in jobs]
        self.objs[slots] = list(jobs)
        sla = self.sla
        slot_list = slots.tolist()
        sview: List[bool] = []
        sslot: List[int] = []
        for k, j in enumerate(jobs):
            d = j.__dict__
            d["_table"] = self
            d["_slot"] = slot_list[k]
            j.__class__ = TableJob
            acc = d["account"]
            if (
                sla is not None
                and isinstance(acc, FleetSlotAccount)
                and acc.ledger is sla
            ):
                d["account"] = _TableSlotAccount(acc, self, slot_list[k])
                sview.append(True)
                sslot.append(acc.slot)
            else:
                sview.append(False)
                sslot.append(-1)
        self.sla_view[slots] = sview
        self.sla_slot[slots] = sslot
        return slots

    def detach_batch(self, slots: np.ndarray) -> None:
        """Detach every job at ``slots`` at once: column values are
        gathered vectorized and pushed back onto the instances with one
        dict update each, rows are reset with masked writes (the
        simulator detaches completions in batches of one tick's
        finishers)."""
        slots = np.asarray(slots, np.int64)
        if slots.size == 0:
            return
        rows = list(zip(*(getattr(self, f)[slots].tolist() for f in _SCALAR_FIELDS)))
        done_l = [None if np.isnan(v) else float(v) for v in self.done_at[slots]]
        clus = [self.cluster_id(c) for c in self.cluster_idx[slots].tolist()]
        objs = self.objs[slots]
        for k in range(slots.size):
            job = objs[k]
            acc = job.account
            d = job.__dict__
            d.pop("_table", None)
            d.pop("_slot", None)
            job.__class__ = Job
            d.update(zip(_SCALAR_FIELDS, rows[k]))
            d["done_at"] = done_l[k]
            d["cluster"] = clus[k]
            if isinstance(acc, _TableSlotAccount):
                plain = FleetSlotAccount.__new__(FleetSlotAccount)
                plain.ledger = acc.ledger
                plain.tier = acc.tier
                plain.demand = acc.demand
                plain.slot = acc.slot
                d["account"] = plain
        for name, _, fill in _COLUMNS:
            getattr(self, name)[slots] = fill
        self.ids[slots] = None
        self.objs[slots] = None
        self._free.extend(slots.tolist())

    def view(self, slots: np.ndarray) -> "JobView":
        return JobView(self, slots)


class JobView:
    """A set of table-backed jobs addressed by slot array.

    The simulator hands this to ``ElasticPolicy.decide`` so the
    vectorized path can slice the table's columns directly; iterating or
    indexing yields the adopted ``Job`` objects for the scalar
    fallbacks (reference oracle, rare placement escapes).
    """

    __slots__ = ("table", "slots")

    def __init__(self, table: JobTable, slots: np.ndarray):
        self.table = table
        self.slots = np.asarray(slots, np.int64)

    def __len__(self) -> int:
        return int(self.slots.size)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self.table.objs[s] for s in self.slots[i]]
        return self.table.objs[self.slots[i]]

    def __iter__(self):
        objs = self.table.objs
        for s in self.slots:
            yield objs[s]


def shared_table(jobs):
    """``(table, slots)`` when every job is a live view on ONE
    ``JobTable``; ``(None, None)`` otherwise — mixed plain/table or
    foreign-table job lists fall back to the per-job build path, the
    same contract as ``policy._shared_ledger``."""
    if isinstance(jobs, JobView):
        return jobs.table, jobs.slots
    table = None
    slots = np.empty(len(jobs), np.int64)
    for k, j in enumerate(jobs):
        if type(j) is not TableJob:
            return None, None
        if table is None:
            table = j._table
        elif j._table is not table:
            return None, None
        slots[k] = j._slot
    return table, slots


class _TableSlotAccount(FleetSlotAccount):
    """A ``FleetSlotAccount`` that mirrors its ledger slot into the
    owning ``JobTable``'s ``sla_slot`` column whenever it registers —
    every record path funnels through ``ensure_slot``, so the column can
    never go stale and the policy may trust it without re-reading the
    account objects."""

    __slots__ = ("table", "row")

    def __init__(self, acc: FleetSlotAccount, table: JobTable, row: int):
        self.ledger = acc.ledger
        self.tier = acc.tier
        self.demand = acc.demand
        self.slot = acc.slot
        self.table = table
        self.row = row

    def ensure_slot(self) -> int:
        slot = super().ensure_slot()
        self.table.sla_slot[self.row] = slot
        return slot


def _int_col(name):
    def fget(self):
        return int(getattr(self._table, name)[self._slot])

    def fset(self, v):
        getattr(self._table, name)[self._slot] = v

    return property(fget, fset)


def _float_col(name):
    def fget(self):
        return float(getattr(self._table, name)[self._slot])

    def fset(self, v):
        getattr(self._table, name)[self._slot] = v

    return property(fget, fset)


def _bool_col(name):
    def fget(self):
        return bool(getattr(self._table, name)[self._slot])

    def fset(self, v):
        getattr(self._table, name)[self._slot] = v

    return property(fget, fset)


class TableJob(Job):
    """A ``Job`` whose numeric state lives in a ``JobTable`` row.

    Instances are never constructed: ``JobTable.adopt`` flips a plain
    ``Job``'s class to this one (and ``detach`` flips it back), the same
    way ``Job.account`` becomes a ``FleetSlotAccount`` view.  Property
    accessors return plain Python scalars so reprs, digests and
    comparisons match a scalar ``Job`` exactly."""

    demand_gpus = _int_col("demand_gpus")
    min_gpus = _int_col("min_gpus")
    allocated = _int_col("allocated")
    checkpoint_bytes = _int_col("checkpoint_bytes")
    knee_gpus = _int_col("knee_gpus")
    sat_slope = _float_col("sat_slope")
    arrival = _float_col("arrival")
    restore_debt = _float_col("restore_debt")
    queued_since = _float_col("queued_since")
    progress = _float_col("progress")
    snap_progress = _float_col("snap_progress")
    snap_time = _float_col("snap_time")
    downtime_until = _float_col("downtime_until")
    downtime_seconds = _float_col("downtime_seconds")
    gpu_hours = _float_col("gpu_hours")
    splice_overhead = _float_col("splice_overhead")
    ever_ran = _bool_col("ever_ran")
    service = _bool_col("service")

    @property
    def done_at(self) -> Optional[float]:
        v = self._table.done_at[self._slot]
        return None if np.isnan(v) else float(v)

    @done_at.setter
    def done_at(self, v: Optional[float]) -> None:
        self._table.done_at[self._slot] = np.nan if v is None else v

    @property
    def cluster(self) -> Optional[str]:
        return self._table.cluster_id(int(self._table.cluster_idx[self._slot]))

    @cluster.setter
    def cluster(self, v: Optional[str]) -> None:
        self._table.cluster_idx[self._slot] = self._table.cluster_code(v)
