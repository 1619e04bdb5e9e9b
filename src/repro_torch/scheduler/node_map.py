"""Fleet-wide node-granular placement state (the NodeMap).

Placement used to stop at cluster granularity: a job carried a
``cluster_idx`` scalar, and everything below it — which nodes the
replicas actually sit on — was approximated.  Partial-domain failures
picked victims by (arrival, id) packing order, gang/splice constraints
were invisible to placement, and fragmentation could not even be
measured.  The NodeMap makes the node layer real, with the same
struct-of-arrays recipe as ``JobTable``/``FleetSLAAccounts``:

**Node axis** (one entry per node, laid out cluster-contiguously in
``fleet.clusters()`` order; a trailing partial node keeps its TRUE
smaller capacity):

- ``node_cap``      — GPUs physically on the node
- ``node_cluster``  — owning cluster index
- ``node_free``     — GPUs idle and healthy
- ``node_used``     — GPUs held by live job spans
- ``node_out``      — UNCLAMPED sum of outstanding failure claims; dead
  capacity is ``min(cap, out)`` so overlapping failures never resurrect
  capacity when the shorter one repairs first (the cluster-level
  ``_outstanding`` rule, per node)

The invariant ``free + used + min(cap, out) == cap`` holds per node at
every tick and is asserted by :meth:`NodeMap.check`.

**Row axis** (one row per job, row index == the driver's table slot /
trace index): ``row_off``/``row_len`` address a piece pool
(``span_node``/``span_gpus``/``span_row``) holding the job's node span —
the list of (node, gpus) pieces it occupies.  Rows grow by doubling and
are reused after release; the pool is bump-allocated and compacted when
more than half of it is garbage.

**Gang/splice compatibility.**  A job that demands ``D`` GPUs can only
run at world sizes the device-proxy splice supports: divisors of ``D``
(time-sliced shrink) or multiples of ``D`` (scale-out).  ``gang_down``
rounds an arbitrary grant to the largest compatible value below it; the
placement overlay only ever fits compatible gangs, shaped as ``w`` full
nodes plus one remainder piece ``r = g % gpus_per_node`` on a best-fit
partial node (smallest sufficient free count, lowest index on ties).

**Fragmentation.**  A free GPU is *stranded* when it sits in a hole too
small to host the smallest single-node piece any queued gang could use
(``min_piece``).  ``stranded_gpus`` is the fleet-wide count, reported
time-averaged in ``SimResult.fragmentation_stranded_gpus``; the
simulator's defragmentation pass consolidates such holes when the freed
capacity is worth the charged migration downtime (``costs.defrag_worthwhile``).

A copy of ``repro.scheduler.node_map``: only the import prefix differs
(``tests/test_torch_copies.py`` holds the two equal).
"""
from __future__ import annotations

import heapq
from functools import lru_cache
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

import numpy as np

if TYPE_CHECKING:  # avoid the import cycle: types builds the NodeMap
    from repro_torch.scheduler.types import Fleet


# --------------------------------------------------------- gang arithmetic
@lru_cache(maxsize=None)
def splice_divisors(demand: int) -> Tuple[int, ...]:
    """Ascending divisors of ``demand`` — the shrink-side world sizes the
    splice mechanism supports (§5.4)."""
    d = max(1, int(demand))
    return tuple(k for k in range(1, d + 1) if d % k == 0)


def gang_down(g: int, demand: int) -> int:
    """Largest splice-compatible world size at or below ``g`` (0 if none):
    a multiple of ``demand`` when ``g >= demand``, else the largest
    divisor of ``demand`` below it."""
    if g <= 0:
        return 0
    if g >= demand:
        return g - g % demand
    divs = splice_divisors(demand)
    lo = 0
    for d in divs:
        if d > g:
            break
        lo = d
    return lo


def gang_down_vec(galloc: np.ndarray, demand: np.ndarray) -> np.ndarray:
    """Vector ``gang_down`` over per-job grants: multiples round in one
    modulo pass; sub-demand grants loop over the (few) unique demands,
    each resolved with one searchsorted against its divisor table."""
    out = galloc.copy()
    pos = galloc > 0
    ge = pos & (galloc >= demand)
    if ge.any():
        out[ge] = galloc[ge] - galloc[ge] % demand[ge]
    lt = pos & ~ge
    if lt.any():
        for d in np.unique(demand[lt]):
            m = lt & (demand == d)
            divs = np.asarray(splice_divisors(int(d)), np.int64)
            out[m] = divs[np.searchsorted(divs, galloc[m], side="right") - 1]
    return out


@lru_cache(maxsize=None)
def gang_values(demand: int, lo: int, hi: int) -> Tuple[int, ...]:
    """Splice-compatible world sizes in ``[lo, hi]``, descending — the
    candidate ladder for shrink-to-hole placement."""
    vals = [d for d in splice_divisors(demand) if lo <= d <= hi and d < demand]
    m = demand
    while m <= hi:
        if m >= lo:
            vals.append(m)
        m += demand
    return tuple(sorted(vals, reverse=True))


@lru_cache(maxsize=None)
def floor_gang(demand: int, min_gpus: int) -> int:
    """Smallest splice-compatible world size at or above ``min_gpus``
    (0 if none) — the smallest gang a queued job could be admitted at,
    the shape the defragmentation pass tries to unblock.  A floor above
    the demand itself is degenerate: admission grants are capped at the
    demand before placement, so no admissible world size exists and the
    answer is 0, never a multiple the job could not be granted."""
    d = max(1, int(demand))
    lo = max(1, int(min_gpus))
    if lo > d:
        return 0
    vals = gang_values(d, lo, d)
    return vals[-1] if vals else 0


@lru_cache(maxsize=None)
def min_piece(demand: int, min_gpus: int, gpus_per_node: int) -> int:
    """Smallest single-node piece any admissible gang of this job could
    occupy: over every compatible world size ``g >= min_gpus``, the
    smallest of its node pieces (``g`` itself below a node, else the
    remainder ``g % gpus_per_node`` or a full node).  Free capacity in a
    hole smaller than this can never serve the job — it is stranded.
    A degenerate floor above the demand admits no gang at all, so no
    sub-node hole is ever usable: the answer saturates at a full node."""
    gpn = max(1, int(gpus_per_node))
    d = max(1, int(demand))
    lo = max(1, int(min_gpus))
    best = gpn
    if lo > d:
        return best
    for g in gang_values(d, lo, 2 * d):
        if g < gpn:
            piece = g
        else:
            r = g % gpn
            piece = r if r else gpn
        if piece < best:
            best = piece
    return best


# ---------------------------------------------------------------- NodeMap
class NodeMap:
    """Simulator-owned SoA of per-node capacity and per-job node spans."""

    def __init__(
        self,
        node_cap: np.ndarray,
        node_cluster: np.ndarray,
        cluster_lo: np.ndarray,
        cluster_hi: np.ndarray,
        cluster_gpn: np.ndarray,
        capacity_rows: int = 64,
    ):
        self.node_cap = node_cap.astype(np.int64)
        self.node_cluster = node_cluster.astype(np.int64)
        self.node_free = self.node_cap.copy()
        self.node_used = np.zeros_like(self.node_cap)
        self.node_out = np.zeros_like(self.node_cap)
        self.cluster_lo = cluster_lo.astype(np.int64)
        self.cluster_hi = cluster_hi.astype(np.int64)
        self.cluster_gpn = cluster_gpn.astype(np.int64)
        self.n_clusters = int(cluster_lo.size)
        rows = max(1, int(capacity_rows))
        self.row_off = np.zeros(rows, np.int64)
        self.row_len = np.zeros(rows, np.int64)
        self.row_total = np.zeros(rows, np.int64)
        self.row_k = np.full(rows, -1, np.int64)
        pool = max(4, 2 * rows)
        self.span_node = np.zeros(pool, np.int64)
        self.span_gpus = np.zeros(pool, np.int64)
        self.span_row = np.full(pool, -1, np.int64)
        self._pool_n = 0
        self._garbage = 0

    @classmethod
    def from_fleet(cls, fleet: "Fleet", capacity_rows: int = 64) -> "NodeMap":
        caps: List[int] = []
        owner: List[int] = []
        lo: List[int] = []
        hi: List[int] = []
        gpn: List[int] = []
        for k, c in enumerate(fleet.clusters()):
            nc = c.node_capacities()
            lo.append(len(caps))
            caps.extend(nc)
            hi.append(len(caps))
            owner.extend([k] * len(nc))
            gpn.append(max(1, c.gpus_per_node))
        return cls(
            np.asarray(caps, np.int64),
            np.asarray(owner, np.int64),
            np.asarray(lo, np.int64),
            np.asarray(hi, np.int64),
            np.asarray(gpn, np.int64),
            capacity_rows=capacity_rows,
        )

    # ---------------------------------------------------------- row spans
    def _ensure_row(self, row: int) -> None:
        n = self.row_len.size
        if row < n:
            return
        m = max(64, n)
        while m <= row:
            m *= 2
        grow = m - n
        self.row_off = np.concatenate([self.row_off, np.zeros(grow, np.int64)])
        self.row_len = np.concatenate([self.row_len, np.zeros(grow, np.int64)])
        self.row_total = np.concatenate([self.row_total, np.zeros(grow, np.int64)])
        self.row_k = np.concatenate([self.row_k, np.full(grow, -1, np.int64)])

    def _pool_reserve(self, extra: int) -> None:
        need = self._pool_n + extra
        cap = self.span_node.size
        if need <= cap:
            return
        if self._garbage > self._pool_n // 2:
            self._compact()
            need = self._pool_n + extra
            if need <= self.span_node.size:
                return
            cap = self.span_node.size
        m = max(4, cap)
        while m < need:
            m *= 2
        pad = m - cap
        self.span_node = np.concatenate([self.span_node, np.zeros(pad, np.int64)])
        self.span_gpus = np.concatenate([self.span_gpus, np.zeros(pad, np.int64)])
        self.span_row = np.concatenate([self.span_row, np.full(pad, -1, np.int64)])

    def _compact(self) -> None:
        pn = self._pool_n
        keep = self.span_gpus[:pn] > 0
        node = self.span_node[:pn][keep]
        gpus = self.span_gpus[:pn][keep]
        rows = self.span_row[:pn][keep]
        live = int(node.size)
        self.span_node[:live] = node
        self.span_gpus[:live] = gpus
        self.span_row[:live] = rows
        self.span_gpus[live:pn] = 0
        self.span_row[live:pn] = -1
        self._pool_n = live
        self._garbage = 0
        # pieces of one row stay contiguous under a stable filter; each
        # live row owns exactly one run, so boundaries are value changes
        if live:
            change = np.flatnonzero(np.diff(rows) != 0) + 1
            starts = np.concatenate(([0], change))
            self.row_off[rows[starts]] = starts

    def has_span(self, row: int) -> bool:
        return 0 <= row < self.row_len.size and self.row_len[row] > 0

    def span_total(self, row: int) -> int:
        if not self.has_span(row):
            return 0
        return int(self.row_total[row])

    def span_cluster(self, row: int) -> int:
        if not self.has_span(row):
            return -1
        return int(self.row_k[row])

    def row_pieces(self, row: int) -> Tuple[np.ndarray, np.ndarray]:
        if not self.has_span(row):
            return np.empty(0, np.int64), np.empty(0, np.int64)
        sl = slice(int(self.row_off[row]), int(self.row_off[row] + self.row_len[row]))
        return self.span_node[sl], self.span_gpus[sl]

    def row_state(
        self, rows: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(has_span, span_cluster, span_total) gathered for many rows at
        once — the decide path's zero-Python span lookup."""
        safe = (rows >= 0) & (rows < self.row_len.size)
        rr = np.where(safe, rows, 0)
        has = safe & (self.row_len[rr] > 0)
        tot = np.where(has, self.row_total[rr], 0)
        k = np.where(has, self.row_k[rr], -1)
        return has, k, tot

    def assign(self, row: int, nodes: Sequence[int], gpus: Sequence[int]) -> None:
        """Install a span (one piece per distinct node).  ``release`` any
        previous span first."""
        self._ensure_row(row)
        assert self.row_len[row] == 0, f"row {row} already holds a span"
        nodes = np.asarray(nodes, np.int64)
        gpus = np.asarray(gpus, np.int64)
        n = int(nodes.size)
        assert n > 0 and (gpus > 0).all()
        self._pool_reserve(n)
        off = self._pool_n
        self.span_node[off : off + n] = nodes
        self.span_gpus[off : off + n] = gpus
        self.span_row[off : off + n] = row
        self._pool_n = off + n
        self.row_off[row] = off
        self.row_len[row] = n
        self.row_total[row] = int(gpus.sum())
        self.row_k[row] = int(self.node_cluster[nodes[0]])
        self.node_free[nodes] -= gpus
        self.node_used[nodes] += gpus
        assert (self.node_free[nodes] >= 0).all(), (
            f"node over-subscribed placing row {row}"
        )

    def release(self, row: int) -> None:
        if not self.has_span(row):
            return
        ln = int(self.row_len[row])
        sl = slice(int(self.row_off[row]), int(self.row_off[row]) + ln)
        nodes = self.span_node[sl]
        gpus = self.span_gpus[sl]
        self.node_free[nodes] += gpus
        self.node_used[nodes] -= gpus
        self.span_gpus[sl] = 0
        self.span_row[sl] = -1
        self._garbage += ln
        self.row_len[row] = 0
        self.row_total[row] = 0
        self.row_k[row] = -1

    def live_rows(self) -> np.ndarray:
        return np.flatnonzero(self.row_len > 0)

    def auto_fit(self, row: int, k: int, gpus: int) -> None:
        """Lowest-index greedy fill ignoring gang shape — the fallback
        span for policies that do not plan node placement (the static
        gang baseline, hand-written policies).  Asserts the cluster can
        hold the grant: per-node conservation rejects over-allocation
        even for planless policies."""
        lo, hi = int(self.cluster_lo[k]), int(self.cluster_hi[k])
        seg = self.node_free[lo:hi]
        nodes: List[int] = []
        take: List[int] = []
        rem = int(gpus)
        for j in np.flatnonzero(seg > 0):
            t = min(rem, int(seg[j]))
            nodes.append(lo + int(j))
            take.append(t)
            rem -= t
            if rem == 0:
                break
        assert rem == 0, (
            f"cluster {k} over-allocated: no node capacity for {gpus} GPUs"
        )
        self.assign(row, nodes, take)

    def move_piece(self, row: int, from_node: int, to_node: int) -> int:
        """Defragmentation move: relocate this row's piece off
        ``from_node`` onto ``to_node`` (merging with an existing piece
        there).  Returns the GPUs moved."""
        nodes, gpus = self.row_pieces(row)
        pieces = {int(n): int(g) for n, g in zip(nodes, gpus)}
        g = pieces.pop(int(from_node))
        pieces[int(to_node)] = pieces.get(int(to_node), 0) + g
        self.release(row)
        self.assign(row, list(pieces.keys()), list(pieces.values()))
        return g

    # ------------------------------------------------------ failure claims
    def fail_claims(self, k: int, want: int) -> List[Tuple[int, int]]:
        """Per-node claim list for a failure of ``want`` GPUs on cluster
        ``k``.  A whole-domain failure claims every node's full capacity
        UNCLAMPED (so it owns the capacity regardless of prior claims);
        a partial failure claims currently-claimable capacity ascending
        by node index, any unclaimable leftover landing on the first
        node for bookkeeping symmetry."""
        lo, hi = int(self.cluster_lo[k]), int(self.cluster_hi[k])
        caps = self.node_cap[lo:hi]
        if want >= int(caps.sum()):
            return [(lo + i, int(caps[i])) for i in range(hi - lo)]
        claims: List[Tuple[int, int]] = []
        remaining = int(want)
        for i in range(lo, hi):
            if remaining <= 0:
                break
            cap = int(self.node_cap[i])
            avail = cap - min(cap, int(self.node_out[i]))
            take = min(avail, remaining)
            if take > 0:
                claims.append((i, take))
                remaining -= take
        if remaining > 0:
            claims.append((lo, remaining))
        return claims

    def apply_claims(self, claims: List[Tuple[int, int]]) -> List[int]:
        """Kill capacity per the claim list.  Each node's effective dead
        increase eats free GPUs first, then kills jobs with pieces on the
        node in ascending row order (the whole gang dies; its span is
        released everywhere).  Returns the victim rows."""
        victims: List[int] = []
        for node, take in claims:
            cap = int(self.node_cap[node])
            old = min(cap, int(self.node_out[node]))
            self.node_out[node] += take
            e = min(cap, int(self.node_out[node])) - old
            x = min(int(self.node_free[node]), e)
            self.node_free[node] -= x
            e -= x
            while e > 0:
                r = self._lowest_row_on(node)
                assert r >= 0, f"node {node}: dead exceeds free+used"
                self.release(r)
                victims.append(r)
                x = min(int(self.node_free[node]), e)
                self.node_free[node] -= x
                e -= x
        return victims

    def repair_claims(self, claims: List[Tuple[int, int]]) -> None:
        """Undo a failure's claims: capacity returns only down to the
        other claims still outstanding on each node."""
        for node, take in claims:
            cap = int(self.node_cap[node])
            old = min(cap, int(self.node_out[node]))
            self.node_out[node] = max(0, int(self.node_out[node]) - take)
            self.node_free[node] += old - min(cap, int(self.node_out[node]))

    def _lowest_row_on(self, node: int) -> int:
        pn = self._pool_n
        m = (self.span_node[:pn] == node) & (self.span_gpus[:pn] > 0)
        rows = self.span_row[:pn][m]
        return int(rows.min()) if rows.size else -1

    def rows_on_node(self, node: int) -> np.ndarray:
        pn = self._pool_n
        m = (self.span_node[:pn] == node) & (self.span_gpus[:pn] > 0)
        return np.unique(self.span_row[:pn][m])

    def cluster_dead(self, k: int) -> int:
        lo, hi = int(self.cluster_lo[k]), int(self.cluster_hi[k])
        return int(
            np.minimum(self.node_cap[lo:hi], self.node_out[lo:hi]).sum()
        )

    def cluster_free_vector(self) -> np.ndarray:
        return np.add.reduceat(self.node_free, self.cluster_lo)

    # ------------------------------------------------------ batched commit
    def release_many(self, rows: np.ndarray) -> None:
        """Batched ``release``: one span-pool gather for many rows at
        once.  Rows without a live span are skipped, like ``release``."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        rows = rows[(rows >= 0) & (rows < self.row_len.size)]
        rows = rows[self.row_len[rows] > 0]
        if rows.size == 0:
            return
        lens = self.row_len[rows]
        offs = self.row_off[rows]
        total = int(lens.sum())
        ends = np.cumsum(lens)
        sl = np.repeat(offs - (ends - lens), lens) + np.arange(total)
        nodes = self.span_node[sl]
        gpus = self.span_gpus[sl]
        # several rows can hold pieces on one node: aggregate first
        un, inv = np.unique(nodes, return_inverse=True)
        add = np.zeros(un.size, np.int64)
        np.add.at(add, inv, gpus)
        self.node_free[un] += add
        self.node_used[un] -= add
        self.span_gpus[sl] = 0
        self.span_row[sl] = -1
        self._garbage += total
        self.row_len[rows] = 0
        self.row_total[rows] = 0
        self.row_k[rows] = -1

    def assign_many(
        self, assigns: Sequence[Tuple[int, Sequence[int], Sequence[int]]]
    ) -> None:
        """Batched ``assign``: install many spans with one pool append,
        laid out exactly as the equivalent sequence of ``assign`` calls
        (pieces of each row contiguous, rows in list order)."""
        if not assigns:
            return
        na = len(assigns)
        rows = np.fromiter((a[0] for a in assigns), np.int64, na)
        counts = np.fromiter((len(a[1]) for a in assigns), np.int64, na)
        total = int(counts.sum())
        nodes = np.fromiter((x for a in assigns for x in a[1]), np.int64, total)
        gpus = np.fromiter((x for a in assigns for x in a[2]), np.int64, total)
        self._ensure_row(int(rows.max()))
        assert np.unique(rows).size == na, "duplicate rows in one plan"
        assert (self.row_len[rows] == 0).all(), "assign_many over live rows"
        assert (counts > 0).all() and (gpus > 0).all()
        self._pool_reserve(total)
        off = self._pool_n
        self.span_node[off : off + total] = nodes
        self.span_gpus[off : off + total] = gpus
        self.span_row[off : off + total] = np.repeat(rows, counts)
        self._pool_n = off + total
        starts = np.cumsum(counts) - counts
        self.row_off[rows] = off + starts
        self.row_len[rows] = counts
        self.row_total[rows] = np.add.reduceat(gpus, starts)
        self.row_k[rows] = self.node_cluster[nodes[starts]]
        un, inv = np.unique(nodes, return_inverse=True)
        take = np.zeros(un.size, np.int64)
        np.add.at(take, inv, gpus)
        self.node_free[un] -= take
        self.node_used[un] += take
        assert (self.node_free[un] >= 0).all(), (
            "node over-subscribed in assign_many"
        )

    # ------------------------------------------------------- fragmentation
    def stranded_gpus(self, queued_shapes: Sequence[Tuple[int, int]]) -> int:
        """Free GPUs sitting in holes no queued gang can use: for each
        cluster, free capacity on nodes with ``0 < free < min_piece``
        where ``min_piece`` is the smallest single-node piece any queued
        (demand, min_gpus) shape admits at that cluster's node size."""
        if not queued_shapes:
            return 0
        total = 0
        for k in range(self.n_clusters):
            gpn = int(self.cluster_gpn[k])
            mp = min(min_piece(d, m, gpn) for d, m in queued_shapes)
            seg = self.node_free[int(self.cluster_lo[k]) : int(self.cluster_hi[k])]
            total += int(seg[(seg > 0) & (seg < mp)].sum())
        return total

    # ----------------------------------------------------------- invariant
    def check(self) -> None:
        dead = np.minimum(self.node_cap, self.node_out)
        assert (self.node_free >= 0).all(), "negative node free count"
        assert (self.node_used >= 0).all(), "negative node used count"
        assert (self.node_free + self.node_used + dead == self.node_cap).all(), (
            "per-node conservation violated (free + used + dead != cap)"
        )
        pn = self._pool_n
        live = self.span_gpus[:pn] > 0
        used = np.zeros(self.node_cap.size, np.int64)
        np.add.at(used, self.span_node[:pn][live], self.span_gpus[:pn][live])
        assert (used == self.node_used).all(), "span pool != node_used"

    def overlay(self) -> "PlacementOverlay":
        return PlacementOverlay(self)


# ------------------------------------------------------- placement overlay
class PlacementOverlay:
    """A decide-pass view of node free counts: the policy releases and
    fits spans against the overlay without touching the NodeMap, and the
    accumulated plan (``released`` rows + ``assigns`` pieces) is committed
    by the simulator's ``_apply``.

    Per-cluster gang-feasibility stats (empty-node count, largest partial
    hole) are maintained *incrementally*: ``_hist[k][f]`` counts cluster
    ``k``'s nodes holding exactly ``f`` free GPUs, built with one bincount
    at overlay creation and bumped as every fit/release lands.  That makes
    ``feasible``/``_stats`` O(1) reads instead of per-query segment
    rescans — the property the batched decide core leans on to test a
    placement per changed job per tick.

    Two more structures keep the per-fit cost scalar instead of
    array-sized:

    * **Free-size buckets** — ``_buck[(k, f)]`` lazily materializes the
      index-ordered list of cluster-``k`` nodes holding exactly ``f``
      free GPUs (a sorted snapshot plus a heap of nodes pushed as their
      free count changes).  Entries are validated against ``free`` at
      pop time, so stale ones cost one discard instead of eager
      maintenance, and ``fit`` becomes a handful of list/heap ops.
    * **Lazy cluster max-heap** — ``pick_cluster`` answers the batched
      core's per-job ``argmax(cfree)``-over-feasible-clusters query
      from ``_cheap``, a heap of ``(-cfree, cluster)`` entries pushed
      on every capacity change and validated against the live mirror at
      pop time (stale entries cost one discard).  Heap order is exactly
      argmax order — cfree descending, index ascending on ties — so the
      first feasible head is the oracle's answer, usually after one or
      two probes; infeasible heads are stashed and pushed back.

    The python list ``_cfree`` is the authoritative per-cluster free
    count (the hot paths only touch lists); ``cfree`` is a property that
    lazily re-syncs a numpy view of it on read, so the loop oracle,
    phase A/C of the batched core, the defragmentation pass, and the
    tests still consume it vectorized."""

    __slots__ = (
        "nm",
        "free",
        "_cfree_np",
        "_dirty",
        "_cfree",
        "_cheap",
        "_gpn",
        "_bkey",
        "_hist",
        "_empty",
        "_maxp",
        "_buck",
        "released",
        "assigns",
    )

    def __init__(self, nm: NodeMap):
        self.nm = nm
        self.free = nm.node_free.copy()
        self._cfree_np = nm.cluster_free_vector().astype(np.int64)
        self._dirty = False
        k = nm.n_clusters
        gmax = int(nm.cluster_gpn.max()) if k else 0
        self._bkey = gmax + 1
        hist = np.bincount(
            nm.node_cluster * (gmax + 1) + self.free,
            minlength=k * (gmax + 1),
        ).reshape(k, gmax + 1)
        self._hist = [row.tolist() for row in hist]
        self._gpn = nm.cluster_gpn.tolist()
        self._empty = [self._hist[i][self._gpn[i]] for i in range(k)]
        self._maxp = [0] * k
        for kk in range(k):
            self._retally(kk)
        self._cfree = self._cfree_np.tolist()
        self._cheap = [(-v, c) for c, v in enumerate(self._cfree)]
        heapq.heapify(self._cheap)
        self._buck: dict = {}
        self.released: List[int] = []
        self.assigns: List[Optional[Tuple[int, List[int], List[int]]]] = []

    # ------------------------------------------------ incremental stats
    def _retally(self, k: int) -> None:
        """Largest partial hole from the histogram row — one
        O(gpus_per_node) scan, needed only when the bin holding the
        previous maximum empties."""
        h = self._hist[k]
        m = 0
        for f in range(1, self._gpn[k]):
            if h[f]:
                m = f
        self._maxp[k] = m

    def _move(self, k: int, j: int, old: int, new: int, popped: bool = False) -> None:
        """Node ``j`` moves ``old → new`` free GPUs: histogram bins, the
        empty/max-partial stats, and (when the buckets involved have
        already been built) a push into the ``new`` bucket so later fits
        can pop it in index order, plus a stale count on the ``old``
        bucket unless the caller obtained ``j`` by popping it (an
        unpopped leaver's entry lingers until a pop discards it)."""
        h = self._hist[k]
        h[old] -= 1
        h[new] += 1
        gpn = self._gpn[k]
        if old == gpn:
            self._empty[k] -= 1
        if new == gpn:
            self._empty[k] += 1
        if 0 < new < gpn and new > self._maxp[k]:
            self._maxp[k] = new
        elif 0 < old < gpn and old == self._maxp[k] and h[old] == 0:
            self._retally(k)
        buck = self._buck
        if not popped and old > 0:
            bo = buck.get(k * self._bkey + old)
            if bo is not None:
                bo[3] += 1
        if new > 0:
            b = buck.get(k * self._bkey + new)
            if b is not None:
                heapq.heappush(b[2], j)

    # --------------------------------------------- cluster capacity mirror
    @property
    def cfree(self) -> np.ndarray:
        """Per-cluster free GPUs as a numpy vector, re-synced from the
        authoritative python list on read when a fit/release dirtied it.
        The array object is stable across the overlay's lifetime."""
        arr = self._cfree_np
        if self._dirty:
            arr[:] = self._cfree
            self._dirty = False
        return arr

    def _cfree_dec(self, k: int, d: int) -> None:
        """Consume ``d`` free GPUs on cluster ``k`` and push the new
        value onto the pick heap."""
        v = self._cfree[k] = self._cfree[k] - d
        self._dirty = True
        heapq.heappush(self._cheap, (-v, k))

    def _cfree_inc(self, k: int, d: int) -> None:
        """Return ``d`` free GPUs to cluster ``k``."""
        v = self._cfree[k] = self._cfree[k] + d
        self._dirty = True
        heapq.heappush(self._cheap, (-v, k))

    # ------------------------------------------------- free-size buckets
    def _bucket(self, k: int, f: int) -> list:
        key = k * self._bkey + f
        b = self._buck.get(key)
        if b is None:
            nm = self.nm
            lo = int(nm.cluster_lo[k])
            hi = int(nm.cluster_hi[k])
            arr = np.flatnonzero(self.free[lo:hi] == f) + lo
            # [sorted base snapshot, base ptr, late-push heap,
            #  stale count, base snapshot as an array (for view writes)]
            b = [arr.tolist(), 0, [], 0, arr]
            self._buck[key] = b
        return b

    def _pop_node(self, k: int, f: int) -> int:
        """Pop the lowest-index cluster-``k`` node currently holding
        exactly ``f`` free GPUs (-1 if none).  Candidates are validated
        lazily against ``free``: a popped entry whose free count moved
        on since it was recorded costs one discard, which keeps pushes
        unconditional and the snapshot base maintenance-free.  The
        bucket's stale count tracks discards-to-come exactly, so a
        zero-stale bucket can be consumed by slicing (see ``fit``)."""
        b = self._bucket(k, f)
        base, extra = b[0], b[2]
        free = self.free
        nb = len(base)
        while True:
            p = b[1]
            if p < nb:
                j = base[p]
                if extra and extra[0] < j:
                    j = heapq.heappop(extra)
                else:
                    b[1] = p + 1
            elif extra:
                j = heapq.heappop(extra)
            else:
                return -1
            if free[j] == f:
                return j
            b[3] -= 1

    # -------------------------------------------------- release and undo
    def release_row(self, row: int) -> None:
        nm = self.nm
        nodes, gpus = nm.row_pieces(row)
        if nodes.size:
            free = self.free
            ks = nm.node_cluster[nodes]
            cadd: dict = {}
            for j, kk, g in zip(nodes.tolist(), ks.tolist(), gpus.tolist()):
                old = int(free[j])
                free[j] = old + g
                cadd[kk] = cadd.get(kk, 0) + g
                self._move(kk, j, old, old + g)
            for kk, g in cadd.items():
                self._cfree_inc(kk, g)
        self.released.append(int(row))

    def release_rows(self, rows: np.ndarray) -> None:
        """Release many rows with one span-pool gather, appending to
        ``released`` in input order — the batched decide core's
        replacement for a per-row ``release_row`` loop."""
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return
        nm = self.nm
        lens = nm.row_len[rows]
        offs = nm.row_off[rows]
        total = int(lens.sum())
        if total:
            ends = np.cumsum(lens)
            sl = np.repeat(offs - (ends - lens), lens) + np.arange(total)
            nodes = nm.span_node[sl]
            gpus = nm.span_gpus[sl]
            # one node can carry pieces of several rows: aggregate first
            un, inv = np.unique(nodes, return_inverse=True)
            add = np.zeros(un.size, np.int64)
            np.add.at(add, inv, gpus)
            free = self.free
            ks = nm.node_cluster[un]
            cadd: dict = {}
            for j, kk, g in zip(un.tolist(), ks.tolist(), add.tolist()):
                old = int(free[j])
                free[j] = old + g
                cadd[kk] = cadd.get(kk, 0) + g
                self._move(kk, j, old, old + g)
            for kk, g in cadd.items():
                self._cfree_inc(kk, g)
        self.released.extend(int(r) for r in rows)

    def undo(self, idx: int) -> None:
        """Reverse a fit made earlier this pass (the entry is tombstoned;
        the caller filters ``assigns`` before committing)."""
        row, nodes, gpus = self.assigns[idx]
        free = self.free
        ncl = self.nm.node_cluster
        for j, g in zip(nodes, gpus):
            old = int(free[j])
            free[j] = old + g
            kk = int(ncl[j])
            self._cfree_inc(kk, g)
            self._move(kk, j, old, old + g)
        self.assigns[idx] = None

    # ------------------------------------------------ feasibility queries
    def _stats(self, k: int) -> Tuple[int, int]:
        return self._empty[k], self._maxp[k]

    def feasible(self, k: int, g: int) -> bool:
        """Can cluster ``k`` host a gang of ``g`` as ``w`` full nodes plus
        one remainder piece?"""
        gpn = self._gpn[k]
        w, r = divmod(int(g), gpn)
        empty = self._empty[k]
        if empty < w:
            return False
        return r == 0 or self._maxp[k] >= r or empty >= w + 1

    def feasible_vec(self, g: int) -> np.ndarray:
        """``feasible`` for every cluster at once — one vector expression
        over the maintained stats.  The batched core walks
        ``pick_cluster`` instead; this remains the loop oracle's (and
        the tests') view."""
        gpn = self.nm.cluster_gpn
        w = g // gpn
        r = g - w * gpn
        empty = np.asarray(self._empty, np.int64)
        maxp = np.asarray(self._maxp, np.int64)
        return (empty >= w) & ((r == 0) | (maxp >= r) | (empty >= w + 1))

    def best_value(self, k: int, demand: int, lo: int, hi: int) -> int:
        """Largest splice-compatible world size in ``[lo, hi]`` that
        cluster ``k`` can host (0 if none)."""
        for v in gang_values(int(demand), int(lo), int(hi)):
            if self.feasible(k, v):
                return v
        return 0

    # --------------------------------------------------- cluster picking
    def best_cluster(self) -> int:
        """``argmax(cfree)`` (lowest index on ties)."""
        best = -1
        bestv = -1
        for c, v in enumerate(self._cfree):
            if v > bestv:
                best, bestv = c, v
        return best

    def best_healthy(self, drain: Sequence[bool]) -> int:
        """``argmax(cfree)`` over non-draining clusters (lowest index on
        ties); -1 when every cluster is draining."""
        best = -1
        bestv = -1
        for c, v in enumerate(self._cfree):
            if v > bestv and not drain[c]:
                best, bestv = c, v
        return best

    def pick_cluster(
        self,
        g: int,
        drain: Optional[Sequence[bool]] = None,
        want_region: int = -1,
        creg: Optional[Sequence[int]] = None,
    ) -> int:
        """The batched core's pool pick: the max-``cfree`` cluster
        (lowest index on ties) passing the oracle's pool filters.

        Stage 1 considers gang-feasible clusters; stage 2 (when no
        cluster is gang-feasible) accepts aggregate capacity
        ``cfree >= g``.  ``drain`` soft-excludes draining clusters when
        a non-draining candidate exists; ``want_region`` (with ``creg``,
        cluster→region codes) soft-prefers a running job's current
        region within whatever pool survives the drain filter.  Each
        preference is dropped, not enforced, when it can't be met —
        byte-for-byte the oracle's nested ``pool``-masking followed by
        ``argmax(where(pool, cfree, -1))``, whose ties break to the
        lowest index.  Returns -1 when even aggregate capacity is
        missing everywhere.

        The unfiltered query pops the lazy max-heap: heads whose entry
        no longer matches the live ``cfree`` mirror are discarded, the
        first feasible valid head is the answer, and valid-but-
        infeasible heads are stashed and pushed back — so the usual
        pick costs one or two probes, not a K-cluster scan."""
        g = int(g)
        if drain is not None or want_region >= 0:
            k = self._pick_filtered(g, drain, want_region, creg, True)
            if k >= 0:
                return k
            return self._pick_filtered(g, drain, want_region, creg, False)
        cf = self._cfree
        heap = self._cheap
        empty = self._empty
        maxp = self._maxp
        gpnl = self._gpn
        found = -1
        stash = None
        while heap:
            v, c = heap[0]
            if cf[c] != -v:
                heapq.heappop(heap)  # stale (or duplicate) entry
                continue
            gpn = gpnl[c]
            w = g // gpn
            r = g - w * gpn
            e = empty[c]
            if e >= w and (r == 0 or maxp[c] >= r or e > w):
                found = c
                break
            if stash is None:
                stash = []
            stash.append(heapq.heappop(heap))
        if stash:
            for e in stash:
                heapq.heappush(heap, e)
        if found >= 0:
            return found
        # stage 2: scattered fill wherever aggregate capacity fits
        best = -1
        bestv = g - 1
        for c, v in enumerate(cf):
            if v > bestv:
                best, bestv = c, v
        return best

    def _pick_filtered(
        self,
        g: int,
        drain: Optional[Sequence[bool]],
        want_region: int,
        creg: Optional[Sequence[int]],
        gang: bool,
    ) -> int:
        """One filtered scan: the argmax candidate under each surviving
        preference combination, resolved exactly as the oracle's pool
        masking does."""
        feasible = self.feasible
        best = b_nd = b_sr = b_sr_nd = -1
        bv = b_nd_v = b_sr_v = b_sr_nd_v = -1
        for c, v in enumerate(self._cfree):
            if gang:
                if not feasible(c, g):
                    continue
            elif v < g:
                continue
            if v > bv:
                best, bv = c, v
            nd = drain is None or not drain[c]
            if nd and v > b_nd_v:
                b_nd, b_nd_v = c, v
            if want_region >= 0 and creg[c] == want_region:
                if v > b_sr_v:
                    b_sr, b_sr_v = c, v
                if nd and v > b_sr_nd_v:
                    b_sr_nd, b_sr_nd_v = c, v
        if best < 0:
            return -1
        if drain is not None and b_nd >= 0:
            if want_region >= 0 and b_sr_nd >= 0:
                return b_sr_nd
            return b_nd
        if want_region >= 0 and b_sr >= 0:
            return b_sr
        return best

    # --------------------------------------------------------------- fits
    def fit_any(self, row: int, k: int, g: int) -> None:
        """Place a gang that fits the cluster's aggregate free capacity:
        the clean shape (``fit``) when feasible, else a scattered fill —
        largest holes first (lowest node index on ties, pinned by a
        stable sort), which minimizes the piece count.  The device-proxy
        makes scattered placement legal; it is merely the low-locality
        fallback the defragmentation pass exists to avoid."""
        g = int(g)
        gpn = self._gpn[k]
        w = g // gpn
        r = g - w * gpn
        empty = self._empty[k]
        if empty >= w and (r == 0 or self._maxp[k] >= r or empty > w):
            self._fit_shaped(row, k, g, gpn, w, r)
            return
        nm = self.nm
        lo, hi = int(nm.cluster_lo[k]), int(nm.cluster_hi[k])
        seg = self.free[lo:hi]
        order = np.argsort(-seg, kind="stable")
        nodes: List[int] = []
        gpus: List[int] = []
        rem = int(g)
        for j in order:
            take = min(rem, int(seg[j]))
            if take <= 0:
                break
            nodes.append(lo + int(j))
            gpus.append(take)
            old = int(seg[j])
            seg[j] -= take
            self._move(k, lo + int(j), old, old - take)
            rem -= take
            if rem == 0:
                break
        assert rem == 0, "fit_any() without aggregate capacity"
        self._cfree_dec(k, int(g))
        self.assigns.append((row, nodes, gpus))

    def fit(self, row: int, k: int, g: int) -> None:
        """Place a feasible gang: full pieces on the lowest-index empty
        nodes, the remainder best-fit into the smallest sufficient
        partial hole (lowest index on ties; the next empty node when no
        partial hole fits).  The best-fit hole size comes straight from
        the histogram, and each node comes from a bucket pop — no
        candidate scan over the segment."""
        g = int(g)
        gpn = self._gpn[k]
        w = g // gpn
        self._fit_shaped(row, k, g, gpn, w, g - w * gpn)

    def _fit_shaped(
        self, row: int, k: int, g: int, gpn: int, w: int, r: int
    ) -> None:
        free = self.free
        nodes: List[int] = []
        gpus: List[int] = []
        h = self._hist[k]
        if w:
            # inline bulk pop: drain the empty-node bucket in index
            # order with one bucket fetch for the whole gang
            b = self._buck.get(k * self._bkey + gpn)
            if b is None:
                b = self._bucket(k, gpn)
            base, extra = b[0], b[2]
            p = b[1]
            if not extra and not b[3] and len(base) - p >= w:
                # exact bucket, no late pushes: the next w base entries
                # ARE the w lowest-index empties — consume by slice and
                # zero their free counts in one array-view fancy write
                nodes = base[p : p + w]
                b[1] = p + w
                free[b[4][p : p + w]] = 0
            else:
                nb = len(base)
                take = 0
                while take < w:
                    p = b[1]
                    if extra and (p >= nb or extra[0] < base[p]):
                        j = heapq.heappop(extra)
                    else:
                        assert p < nb, "fit() without feasibility"
                        j = base[p]
                        b[1] = p + 1
                    if free[j] == gpn:
                        free[j] = 0
                        nodes.append(j)
                        take += 1
                    else:
                        b[3] -= 1
            gpus = [gpn] * w
            h[gpn] -= w
            h[0] += w
            self._empty[k] -= w
        if r:
            f = 0
            for b in range(r, gpn):
                if h[b]:
                    f = b
                    break
            if f:
                j = self._pop_node(k, f)
                assert j >= 0, "fit() without feasibility"
                free[j] = f - r
                self._move(k, j, f, f - r, popped=True)
            else:
                j = self._pop_node(k, gpn)
                assert j >= 0, "fit() without feasibility"
                free[j] = gpn - r
                self._move(k, j, gpn, gpn - r, popped=True)
            nodes.append(j)
            gpus.append(r)
        self._cfree_dec(k, int(g))
        self.assigns.append((row, nodes, gpus))

    def fit_batch(self, rows: np.ndarray, ks: np.ndarray, gs: np.ndarray) -> None:
        """Sequentially-equivalent batch fit: exactly one ``fit_any`` per
        item, in order, appending one assign each — but runs of identical
        (cluster, whole-node gang) items collapse into a single
        empty-node slice.  Consecutive shaped whole-node fits each take
        the next lowest-index empties, so the slice IS the sequential
        answer; items past the run's empty budget fall back to the
        per-item path (scattered fill), exactly as the loop would."""
        n = len(rows)
        i = 0
        while i < n:
            k = int(ks[i])
            g = int(gs[i])
            gpn = self._gpn[k]
            w, r = divmod(g, gpn)
            if r == 0 and w > 0:
                j = i + 1
                while j < n and int(ks[j]) == k and int(gs[j]) == g:
                    j += 1
                m = min(j - i, self._empty[k] // w)
                if m > 0:
                    lo = int(self.nm.cluster_lo[k])
                    hi = int(self.nm.cluster_hi[k])
                    seg = self.free[lo:hi]
                    empt = np.flatnonzero(seg == gpn)[: m * w]
                    seg[empt] = 0
                    bb = self._buck.get(k * self._bkey + gpn)
                    if bb is not None:
                        # consumed without popping: their bucket entries
                        # (if the bucket predates this call) linger
                        bb[3] += m * w
                    h = self._hist[k]
                    h[gpn] -= m * w
                    h[0] += m * w
                    self._empty[k] -= m * w
                    self._cfree_dec(k, m * g)
                    whole = [gpn] * w
                    for t in range(m):
                        ns = [lo + int(x) for x in empt[t * w : (t + 1) * w]]
                        self.assigns.append((int(rows[i + t]), ns, list(whole)))
                for t in range(i + m, j):
                    self.fit_any(int(rows[t]), k, int(gs[t]))
                i = j
            else:
                self.fit_any(int(rows[i]), k, g)
                i += 1
