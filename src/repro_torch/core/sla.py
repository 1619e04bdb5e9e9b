"""GPU-fraction SLAs (§2.5, Table 1).

``gpu_fraction = T_ideal / T_real``: the relative slowdown a job experiences
from preemption/scale-down versus dedicated capacity.  Tiers:

  Premium  — 95% guarantee, almost never preempted, scale-up first.
  Standard — 70% guarantee, infrequent preemption.
  Basic    — best effort (spot-like), preempted first, scale-down first.

The SLA is enforced at an hourly granularity; the scheduler consults
``worst_window_fraction`` when choosing preemption/shrink victims.

Two implementations share the same semantics:

- ``GpuFractionAccount`` — the scalar per-job account.  O(log n) queries,
  incremental per-window caching.  Kept as the reference oracle.
- ``FleetSLAAccounts`` + ``FleetSlotAccount`` — a struct-of-arrays ledger
  holding every active job's intervals in shared numpy arrays, answering
  ``headroom_all``/``worst_window_fraction_all`` for the whole fleet in a
  few batched passes.  This is what keeps the scheduler's decide path
  free of per-job Python loops at million-job scale; the property test in
  ``tests/test_sla_ledger.py`` pins it to the scalar oracle bit-for-bit.

A copy of ``repro.core.sla``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple, Union

import numpy as np

HOUR = 3600.0


@dataclasses.dataclass(frozen=True)
class SLATier:
    name: str
    gpu_fraction: float  # guaranteed T_ideal/T_real
    preempt_priority: int  # lower = preempted later
    scaleup_priority: int  # lower = offered spare capacity first


TIERS = {
    "premium": SLATier("premium", 0.95, preempt_priority=2, scaleup_priority=0),
    "standard": SLATier("standard", 0.70, preempt_priority=1, scaleup_priority=1),
    "basic": SLATier("basic", 0.0, preempt_priority=0, scaleup_priority=2),
}


class GpuFractionAccount:
    """Tracks a job's delivered vs. demanded GPU time over wall intervals.

    The account is on the scheduler's per-tick hot path (the policy consults
    ``headroom`` for every guaranteed job at every tick), so queries must not
    rescan history: contiguous equal-allocation records are coalesced,
    delivered time is answered from a prefix sum in O(log n), and the
    completed-window worst fraction is cached incrementally per window size.
    """

    def __init__(self, tier: str, demand_gpus: int):
        self.tier = TIERS[tier]
        self.demand = demand_gpus
        # (start, end, allocated_gpus); contiguous, append-only, coalesced
        self.intervals: List[Tuple[float, float, int]] = []
        self._starts: List[float] = []
        # _cum[i] = delivered seconds in all intervals before interval i
        self._cum: List[float] = []
        # window size -> (worst over completed windows, next window start)
        self._wcache: dict = {}

    def _weight(self, g: int) -> float:
        return min(g / self.demand, 1.0) if self.demand > 0 else 0.0

    def record(self, start: float, end: float, allocated: int) -> None:
        if end <= start:
            return
        if self.intervals:
            ls, le, lg = self.intervals[-1]
            if lg == allocated and start <= le + 1e-9:
                self.intervals[-1] = (ls, max(le, end), lg)
                return
        self.intervals.append((start, end, allocated))
        self._starts.append(start)
        if len(self.intervals) == 1:
            self._cum.append(0.0)
        else:
            ps, pe, pg = self.intervals[-2]
            self._cum.append(self._cum[-1] + (pe - ps) * self._weight(pg))

    # progress rate while holding g of n demanded GPUs is g/n (work-
    # conserving elasticity; splicing overhead is handled separately)
    def _delivered_before(self, t: float) -> float:
        i = bisect.bisect_right(self._starts, t) - 1
        if i < 0:
            return 0.0
        s, e, g = self.intervals[i]
        return self._cum[i] + max(0.0, min(t, e) - s) * self._weight(g)

    def delivered_seconds(self, t0: float, t1: float) -> float:
        if not self.intervals or t1 <= t0:
            return 0.0
        return max(0.0, self._delivered_before(t1) - self._delivered_before(t0))

    def fraction(self, t0: float, t1: float) -> float:
        if t1 <= t0:
            return 1.0
        return self.delivered_seconds(t0, t1) / (t1 - t0)

    def worst_window_fraction(self, now: float, window: float = HOUR) -> float:
        """Worst fraction over any completed window (hourly enforcement).

        A window is only cached once it is fully behind the recorded
        frontier — its fraction is then final (records are append-only in
        time).  Windows past the frontier are evaluated fresh each call, so
        a query issued before the interval was recorded never poisons the
        cache.
        """
        if not self.intervals:
            return 1.0
        start = self.intervals[0][0]
        frontier = self.intervals[-1][1]
        worst, t = self._wcache.get(window, (1.0, start))
        while t + window <= min(now, frontier) + 1e-9:
            worst = min(worst, self.fraction(t, t + window))
            t += window
        self._wcache[window] = (worst, t)
        # completed windows beyond the recorded frontier: not final yet
        while t + window <= now + 1e-9:
            worst = min(worst, self.fraction(t, t + window))
            t += window
        # also the trailing partial window
        if now > start:
            worst = min(worst, self.fraction(max(start, now - window), now))
        return worst

    def violated(self, now: float) -> bool:
        return self.worst_window_fraction(now) < self.tier.gpu_fraction - 1e-9

    def headroom(self, now: float, window: float = HOUR) -> float:
        """How much fraction above the guarantee this job currently has —
        the scheduler shrinks/preempts high-headroom jobs first."""
        return self.worst_window_fraction(now, window) - self.tier.gpu_fraction


_RELEASED = -2  # view slot marker: the slot was freed back to the ledger


class FleetSLAAccounts:
    """Struct-of-arrays SLA ledger for every active job in the fleet.

    Interval records for all slots live in shared 2-D numpy arrays
    (``start``/``end``/``alloc``/``wgt``/``cum``, one row per slot, grown
    by doubling), mirroring the scalar account exactly: contiguous
    equal-allocation records coalesce, ``cum`` is the delivered-seconds
    prefix sum appended at record time, and the per-window worst fraction
    is cached incrementally with the same unfinalized-frontier rule — a
    window is only cached once it is fully behind the slot's recorded
    frontier, so early queries never poison the cache.

    Queries are batched: ``worst_window_fraction_all``/``headroom_all``
    answer an arbitrary slot subset in a few array passes (a vectorized
    ``bisect_right`` into the interval rows plus one fraction evaluation
    per *window round*, not per job).  Arithmetic is performed in the same
    order as the scalar oracle, so results agree bit-for-bit; the property
    test in ``tests/test_sla_ledger.py`` enforces a 1e-9 bound.

    Slots are registered lazily (on a view's first real record), and
    ``release`` returns a completed job's row to a free list for reuse, so
    live memory tracks the number of *concurrently* active jobs rather
    than the length of the trace.

    **Compaction.**  A months-long churny job appends intervals forever;
    without intervention the shared interval axis doubles without bound.
    Once the axis reaches ``compact_after`` columns, a full slot first
    tries ``_compact_slot``: every interval finalized for all cached
    windows AND older than ``keep_horizon_seconds`` behind the slot's
    recorded frontier collapses into ONE summary interval whose weight
    reproduces the exact delivered-seconds prefix (the absolute ``cum``
    values of the kept suffix are untouched, so deliveries and window
    fractions that only touch the suffix are bit-identical; queries
    *inside* the compacted prefix see its average rate).  Only when
    compaction frees nothing does the axis actually grow — so the axis is
    bounded by churn within the keep horizon, not by job lifetime.
    ``compact_after=None`` disables.
    """

    def __init__(
        self,
        slot_capacity: int = 64,
        interval_capacity: int = 4,
        compact_after: int = 512,
        keep_horizon_seconds: float = 24 * HOUR,
    ):
        self._cap = max(1, int(slot_capacity))
        self._iv_cap = max(2, int(interval_capacity))
        self._compact_after = compact_after
        self._keep_horizon = float(keep_horizon_seconds)
        self._n = 0  # high-water slot mark
        self._free: List[int] = []
        self._demand = np.zeros(self._cap, np.int64)
        self._count = np.zeros(self._cap, np.int64)
        self._first = np.full(self._cap, np.nan)
        # unused cells keep +inf starts so the row binary search is safe
        self._start = np.full((self._cap, self._iv_cap), np.inf)
        self._end = np.zeros((self._cap, self._iv_cap))
        self._alloc = np.zeros((self._cap, self._iv_cap), np.int64)
        self._wgt = np.zeros((self._cap, self._iv_cap))
        self._cum = np.zeros((self._cap, self._iv_cap))
        # window size -> (worst over finalized windows, next window start);
        # a NaN start marks a slot with no cache entry for that window yet
        self._wcache: Dict[float, Tuple[np.ndarray, np.ndarray]] = {}

    # ------------------------------------------------------------- slots
    @property
    def slots_in_use(self) -> int:
        return self._n - len(self._free)

    def register(self, demand_gpus: int) -> int:
        """Claim a slot (reusing released rows first) for a job demanding
        ``demand_gpus`` at full speed."""
        if self._free:
            slot = self._free.pop()
        else:
            if self._n == self._cap:
                self._grow_slots()
            slot = self._n
            self._n += 1
        self._demand[slot] = int(demand_gpus)
        self._reset_slot(slot)
        return slot

    def release(self, slot: int) -> None:
        """Return a slot to the free list (the job completed; its account
        will never be queried again)."""
        self._reset_slot(slot)
        self._free.append(slot)

    def _reset_slot(self, slot: int) -> None:
        self._count[slot] = 0
        self._first[slot] = np.nan
        self._start[slot, :] = np.inf
        for worst, wstart in self._wcache.values():
            worst[slot] = 1.0
            wstart[slot] = np.nan

    @staticmethod
    def _grown(a: np.ndarray, shape, fill) -> np.ndarray:
        out = np.full(shape, fill, dtype=a.dtype)
        if a.ndim == 1:
            out[: a.size] = a
        else:
            out[: a.shape[0], : a.shape[1]] = a
        return out

    def _grow_slots(self) -> None:
        cap = self._cap * 2
        self._demand = self._grown(self._demand, cap, 0)
        self._count = self._grown(self._count, cap, 0)
        self._first = self._grown(self._first, cap, np.nan)
        self._start = self._grown(self._start, (cap, self._iv_cap), np.inf)
        self._end = self._grown(self._end, (cap, self._iv_cap), 0.0)
        self._alloc = self._grown(self._alloc, (cap, self._iv_cap), 0)
        self._wgt = self._grown(self._wgt, (cap, self._iv_cap), 0.0)
        self._cum = self._grown(self._cum, (cap, self._iv_cap), 0.0)
        for window, (worst, wstart) in list(self._wcache.items()):
            self._wcache[window] = (
                self._grown(worst, cap, 1.0),
                self._grown(wstart, cap, np.nan),
            )
        self._cap = cap

    def _grow_intervals(self) -> None:
        cols = self._iv_cap * 2
        self._start = self._grown(self._start, (self._cap, cols), np.inf)
        self._end = self._grown(self._end, (self._cap, cols), 0.0)
        self._alloc = self._grown(self._alloc, (self._cap, cols), 0)
        self._wgt = self._grown(self._wgt, (self._cap, cols), 0.0)
        self._cum = self._grown(self._cum, (self._cap, cols), 0.0)
        self._iv_cap = cols

    # -------------------------------------------------------- compaction
    def _compact_cutoff(self, slot: int) -> float:
        """Latest time before which this slot's intervals are summary-
        safe: behind every cached window's finalized frontier AND at
        least the keep horizon behind the recorded frontier (so trailing
        windows and moderately out-of-order queries stay exact)."""
        cnt = int(self._count[slot])
        cutoff = float(self._end[slot, cnt - 1]) - self._keep_horizon
        for _, wstart in self._wcache.values():
            ws = float(wstart[slot])
            if not np.isnan(ws):
                cutoff = min(cutoff, ws)
        return cutoff

    def _compact_slot(self, slot: int) -> int:
        """Collapse the slot's finalized interval prefix into one summary
        interval; returns the number of rows freed.  The summary weight
        reproduces the exact delivered-seconds total over the prefix, so
        every query outside it is unchanged (to float rounding); queries
        inside it see the prefix's average delivery rate.
        """
        cnt = int(self._count[slot])
        if cnt < 3:
            return 0
        cutoff = self._compact_cutoff(slot)
        # rows fully behind the cutoff (interval ends are strictly
        # increasing: records are append-only in time)
        k = int(np.searchsorted(self._end[slot, :cnt], cutoff, side="right"))
        if k < 2:
            return 0
        s0 = float(self._start[slot, 0])
        last_s = float(self._start[slot, k - 1])
        last_e = float(self._end[slot, k - 1])
        delivered = float(
            self._cum[slot, k - 1] + (last_e - last_s) * self._wgt[slot, k - 1]
        )
        span = last_e - s0
        m = cnt - k  # suffix rows kept verbatim (absolute cum preserved)
        self._start[slot, 1 : 1 + m] = self._start[slot, k:cnt]
        self._end[slot, 1 : 1 + m] = self._end[slot, k:cnt]
        self._alloc[slot, 1 : 1 + m] = self._alloc[slot, k:cnt]
        self._wgt[slot, 1 : 1 + m] = self._wgt[slot, k:cnt]
        self._cum[slot, 1 : 1 + m] = self._cum[slot, k:cnt]
        self._start[slot, 0] = s0
        self._end[slot, 0] = last_e
        self._alloc[slot, 0] = -1  # sentinel: a summary row never coalesces
        self._wgt[slot, 0] = delivered / span if span > 0 else 0.0
        self._cum[slot, 0] = 0.0
        self._start[slot, 1 + m : cnt] = np.inf
        self._end[slot, 1 + m : cnt] = 0.0
        self._alloc[slot, 1 + m : cnt] = 0
        self._wgt[slot, 1 + m : cnt] = 0.0
        self._cum[slot, 1 + m : cnt] = 0.0
        self._count[slot] = m + 1
        return k - 1

    def _maybe_compact(self, slot: int) -> bool:
        """Auto-compaction hook for a full slot on the record path: only
        once the axis has reached ``compact_after`` columns, and only if
        it actually frees rows (otherwise the caller grows the axis)."""
        if self._compact_after is None or self._iv_cap < self._compact_after:
            return False
        return self._compact_slot(slot) > 0

    def compact(self) -> int:
        """Compact every live slot now; returns total rows freed.  The
        auto path (``compact_after``) makes explicit calls unnecessary,
        but long-lived ledgers can invoke this at quiet moments."""
        freed = 0
        free = set(self._free)
        for slot in range(self._n):
            if slot not in free and self._count[slot] > 0:
                freed += self._compact_slot(slot)
        return freed

    # ----------------------------------------------------------- records
    def record_batch(
        self,
        slots: np.ndarray,
        start: np.ndarray,
        end: np.ndarray,
        allocated: np.ndarray,
    ) -> None:
        """Append one (start, end, allocated) record per slot, coalescing
        contiguous equal-allocation records exactly like the scalar
        account.  Records with ``end <= start`` are no-ops.  A slot must
        appear at most once per call (per-slot record order within a tick
        is preserved by issuing multiple calls, as the simulator does for
        the downtime/productive split).
        """
        slots = np.asarray(slots, np.int64)
        start = np.asarray(start, np.float64)
        end = np.asarray(end, np.float64)
        allocated = np.asarray(allocated, np.int64)
        assert np.unique(slots).size == slots.size, "duplicate slot in batch"
        live = end > start
        if not live.any():
            return
        if not live.all():
            slots = slots[live]
            start = start[live]
            end = end[live]
            allocated = allocated[live]
        # compact full slots before growing the shared axis (a summary
        # merge never touches a slot's LAST row, so the coalescing /
        # prefix-sum logic below is unaffected)
        if self._compact_after is not None and self._iv_cap >= self._compact_after:
            for s in slots[self._count[slots] >= self._iv_cap]:
                self._compact_slot(int(s))
        cnt = self._count[slots]
        last = np.maximum(cnt - 1, 0)
        has = cnt > 0
        lend = self._end[slots, last]
        lalloc = self._alloc[slots, last]
        coal = has & (lalloc == allocated) & (start <= lend + 1e-9)
        if coal.any():
            rows = slots[coal]
            self._end[rows, last[coal]] = np.maximum(lend[coal], end[coal])
        app = ~coal
        if not app.any():
            return
        rows = slots[app]
        k = cnt[app]
        while (k >= self._iv_cap).any():
            self._grow_intervals()
        grew = has[app]
        cum_k = np.zeros(rows.size)
        if grew.any():
            rp = rows[grew]
            kp = k[grew] - 1
            cum_k[grew] = (
                self._cum[rp, kp]
                + (self._end[rp, kp] - self._start[rp, kp]) * self._wgt[rp, kp]
            )
        self._cum[rows, k] = cum_k
        self._start[rows, k] = start[app]
        self._end[rows, k] = end[app]
        self._alloc[rows, k] = allocated[app]
        demand = self._demand[rows]
        self._wgt[rows, k] = np.where(
            demand > 0,
            np.minimum(allocated[app] / np.maximum(demand, 1), 1.0),
            0.0,
        )
        self._count[rows] = k + 1
        fresh = ~grew
        if fresh.any():
            self._first[rows[fresh]] = start[app][fresh]

    def record_one(self, slot: int, start: float, end: float, allocated: int) -> None:
        """Scalar append for one slot — identical semantics and identical
        float arithmetic to ``record_batch``, without the per-call array
        allocations (the legacy per-event simulator loop and the views'
        ``record`` are scalar callers on a hot path)."""
        if end <= start:
            return
        cnt = int(self._count[slot])
        if cnt > 0:
            last = cnt - 1
            last_end = float(self._end[slot, last])
            same = int(self._alloc[slot, last]) == int(allocated)
            if same and start <= last_end + 1e-9:
                if end > last_end:
                    self._end[slot, last] = end
                return
        if cnt >= self._iv_cap:
            if self._maybe_compact(slot):
                cnt = int(self._count[slot])
            else:
                self._grow_intervals()
        if cnt > 0:
            prev = cnt - 1
            self._cum[slot, cnt] = (
                self._cum[slot, prev]
                + (self._end[slot, prev] - self._start[slot, prev])
                * self._wgt[slot, prev]
            )
        else:
            self._cum[slot, cnt] = 0.0
            self._first[slot] = start
        self._start[slot, cnt] = start
        self._end[slot, cnt] = end
        self._alloc[slot, cnt] = allocated
        demand = int(self._demand[slot])
        self._wgt[slot, cnt] = min(allocated / demand, 1.0) if demand > 0 else 0.0
        self._count[slot] = cnt + 1

    # ----------------------------------------------------------- queries
    def _delivered_before(self, slots: np.ndarray, t) -> np.ndarray:
        """Vectorized ``bisect_right(starts, t) - 1`` + prefix-sum lookup,
        replicating the scalar account's probe sequence exactly."""
        lo = np.zeros(slots.size, np.int64)
        hi = self._count[slots].astype(np.int64)
        while True:
            open_ = lo < hi
            if not open_.any():
                break
            mid = (lo + hi) // 2
            probe = self._start[slots, np.minimum(mid, self._iv_cap - 1)]
            le = open_ & (probe <= t)
            lo = np.where(le, mid + 1, lo)
            hi = np.where(open_ & ~le, mid, hi)
        i = lo - 1
        i0 = np.maximum(i, 0)
        s = self._start[slots, i0]
        e = self._end[slots, i0]
        part = np.maximum(0.0, np.minimum(t, e) - s) * self._wgt[slots, i0]
        return np.where(i < 0, 0.0, self._cum[slots, i0] + part)

    def _fraction(self, slots: np.ndarray, t0, t1) -> np.ndarray:
        delivered = np.maximum(
            0.0, self._delivered_before(slots, t1) - self._delivered_before(slots, t0)
        )
        return delivered / (t1 - t0)

    def worst_window_fraction_all(
        self, now: float, slots: np.ndarray, window: float = HOUR
    ) -> np.ndarray:
        """Worst completed-window fraction for every slot in ``slots`` at
        ``now`` — the scalar ``worst_window_fraction`` batched.  Slots < 0
        (views not yet registered) and slots with no records answer 1.0,
        like an empty scalar account.  The per-window cache advances only
        over windows behind each slot's recorded frontier.
        """
        slots = np.asarray(slots, np.int64)
        out = np.ones(slots.size)
        act = (slots >= 0) & (self._count[np.maximum(slots, 0)] > 0)
        if not act.any():
            return out
        s = slots[act]
        cached = self._wcache.get(window)
        if cached is None:
            cached = (np.ones(self._cap), np.full(self._cap, np.nan))
            self._wcache[window] = cached
        worst_c, wstart_c = cached
        worst = worst_c[s].copy()
        t = wstart_c[s].copy()
        uninit = np.isnan(t)
        if uninit.any():
            t[uninit] = self._first[s][uninit]
        frontier = self._end[s, self._count[s] - 1]
        lim = np.minimum(now, frontier) + 1e-9
        while True:
            m = t + window <= lim
            if not m.any():
                break
            worst[m] = np.minimum(worst[m], self._fraction(s[m], t[m], t[m] + window))
            t[m] = t[m] + window
        worst_c[s] = worst
        wstart_c[s] = t
        # completed windows beyond the recorded frontier: not final yet,
        # evaluated fresh on local copies so they never enter the cache
        wfresh = worst.copy()
        tfresh = t.copy()
        while True:
            m = tfresh + window <= now + 1e-9
            if not m.any():
                break
            wfresh[m] = np.minimum(
                wfresh[m], self._fraction(s[m], tfresh[m], tfresh[m] + window)
            )
            tfresh[m] = tfresh[m] + window
        # also the trailing partial window
        first = self._first[s]
        m = now > first
        if m.any():
            lo = np.maximum(first[m], now - window)
            wfresh[m] = np.minimum(wfresh[m], self._fraction(s[m], lo, now))
        out[act] = wfresh
        return out

    def headroom_all(
        self,
        now: float,
        slots: np.ndarray,
        gfrac: np.ndarray,
        window: float = HOUR,
    ) -> np.ndarray:
        """Fraction above each slot's guarantee (``gfrac`` aligned with
        ``slots``) — the one batched call the policy's decide path makes."""
        worst = self.worst_window_fraction_all(now, slots, window)
        return worst - np.asarray(gfrac, np.float64)


class FleetSlotAccount:
    """Thin per-job view onto one ``FleetSLAAccounts`` slot.

    Drop-in for ``GpuFractionAccount`` on the ``Job.account`` attribute:
    same query API, same semantics, but the data lives in the fleet
    ledger's shared arrays so the policy can consult the whole fleet in
    one batched call.  The slot is registered lazily on the first real
    record and freed with ``release()`` when the job completes.
    """

    __slots__ = ("ledger", "slot", "tier", "demand")

    def __init__(self, ledger: FleetSLAAccounts, tier: str, demand_gpus: int):
        self.ledger = ledger
        self.tier = TIERS[tier]
        self.demand = demand_gpus
        self.slot = -1  # registered on first record

    def _check(self) -> None:
        if self.slot == _RELEASED:
            raise RuntimeError("SLA account was released back to the ledger")

    def ensure_slot(self) -> int:
        """Register with the ledger if not yet; returns the slot index."""
        self._check()
        if self.slot < 0:
            self.slot = self.ledger.register(self.demand)
        return self.slot

    def record(self, start: float, end: float, allocated: int) -> None:
        if end <= start:
            return
        slot = self.ensure_slot()
        self.ledger.record_one(slot, float(start), float(end), int(allocated))

    def worst_window_fraction(self, now: float, window: float = HOUR) -> float:
        self._check()
        slots = np.array([self.slot], np.int64)
        return float(self.ledger.worst_window_fraction_all(now, slots, window)[0])

    def headroom(self, now: float, window: float = HOUR) -> float:
        return self.worst_window_fraction(now, window) - self.tier.gpu_fraction

    def violated(self, now: float) -> bool:
        return self.worst_window_fraction(now) < self.tier.gpu_fraction - 1e-9

    def delivered_seconds(self, t0: float, t1: float) -> float:
        self._check()
        if self.slot < 0 or t1 <= t0 or self.ledger._count[self.slot] == 0:
            return 0.0
        slots = np.array([self.slot], np.int64)
        after = self.ledger._delivered_before(slots, float(t1))
        before = self.ledger._delivered_before(slots, float(t0))
        return max(0.0, float(after[0]) - float(before[0]))

    def fraction(self, t0: float, t1: float) -> float:
        if t1 <= t0:
            return 1.0
        return self.delivered_seconds(t0, t1) / (t1 - t0)

    def release(self) -> None:
        """Free the slot; the account must not be queried afterwards."""
        if self.slot >= 0:
            self.ledger.release(self.slot)
        self.slot = _RELEASED


# what Job.account may hold: the scalar oracle or a ledger-backed view
SLAAccount = Union[GpuFractionAccount, FleetSlotAccount]
