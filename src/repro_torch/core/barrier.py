"""Transparent distributed barrier via tandem meta-allreduces (§4.3.1) (a
copy of ``repro.core.barrier``, which is numpy only; the port keeps its
own).

The protocol, verbatim from the paper:

- Before every data allreduce the worker issues an *asynchronous* tandem
  meta-allreduce: a SUM allreduce over two integers
  ``(need_barrier, ack_barrier)``.  Tandem issue trivially preserves program
  order, the requirement for collective libraries.
- *Phase 1* (steady state): metas are async, payload (0, 0); negligible cost.
- A worker that has received a barrier command contributes ``need=1``.
- A worker that observes a completed meta with ``SUM(need) > 0`` switches to
  *Phase 2*: it contributes ``ack=1`` and goes *synchronous* (every
  collective call blocks until completion) to guarantee timely termination.
- A worker that observes ``SUM(ack) == world_size`` knows every rank is in
  Phase 2 and acquires the barrier after its in-flight pair drains.

Guarantees (property-tested): the barrier is acquired by all ranks with no
in-flight collectives and identical per-communicator issue counts (a
consistent cut), within at most two mini-batches of the command.

For model-parallel jobs (tensor/pipeline groups, p2p send/recv) the paper
uses domain knowledge instead of reasoning about cross-group ordering: the
tandem meta is issued ONCE per mini-batch, at the end, where no collective
is in flight in any dimension (``mode="minibatch_end"``).

The engine below is a deterministic cooperative-interleaving simulator:
``hypothesis`` drives adversarial schedules in the tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Collective engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Instance:
    """One collective call instance on a communicator (identified by seq)."""
    payloads: Dict[int, Tuple[int, ...]] = dataclasses.field(default_factory=dict)

    def complete(self, world: int) -> bool:
        return len(self.payloads) == world

    def total(self) -> Tuple[int, ...]:
        vals = list(self.payloads.values())
        return tuple(int(sum(v[i] for v in vals)) for i in range(len(vals[0])))


class CollectiveEngine:
    """Tracks per-communicator call streams; a call completes when every
    participating rank has issued its matching (same-seq) call."""

    def __init__(self, world_size: int):
        self.world = world_size
        self.comms: Dict[str, Dict] = {}

    def register(self, comm: str, ranks: Optional[List[int]] = None) -> None:
        ranks = list(range(self.world)) if ranks is None else ranks
        self.comms[comm] = {"ranks": ranks, "seq": {r: 0 for r in ranks},
                            "instances": {}}

    def issue(self, comm: str, rank: int, payload: Tuple[int, ...] = (0,)) -> int:
        c = self.comms[comm]
        seq = c["seq"][rank]
        c["seq"][rank] = seq + 1
        inst = c["instances"].setdefault(seq, _Instance())
        inst.payloads[rank] = payload
        return seq

    def is_complete(self, comm: str, seq: int) -> bool:
        c = self.comms[comm]
        inst = c["instances"].get(seq)
        return inst is not None and inst.complete(len(c["ranks"]))

    def result(self, comm: str, seq: int) -> Tuple[int, ...]:
        assert self.is_complete(comm, seq)
        return self.comms[comm]["instances"][seq].total()

    def in_flight(self, comm: str) -> int:
        c = self.comms[comm]
        world = len(c["ranks"])
        return sum(0 if i.complete(world) else 1
                   for i in c["instances"].values())

    def issue_counts(self, comm: str) -> List[int]:
        return list(self.comms[comm]["seq"].values())


# ---------------------------------------------------------------------------
# Worker state machine
# ---------------------------------------------------------------------------

PHASE1, PHASE2, ACQUIRED = 0, 1, 2


class BarrierWorker:
    """A training worker: each mini-batch issues ``n_collectives`` data
    allreduces (each preceded by its tandem meta) and ends with a sync point.

    ``mode="per_allreduce"`` — data-parallel jobs (meta before every data AR)
    ``mode="minibatch_end"`` — model-parallel jobs (single meta at MB end);
    intra-minibatch collectives then run on group communicators.
    """

    def __init__(self, rank: int, engine: CollectiveEngine, n_collectives: int,
                 mode: str = "per_allreduce",
                 group_comms: Optional[List[str]] = None):
        self.rank = rank
        self.engine = engine
        self.n_collectives = n_collectives
        self.mode = mode
        self.group_comms = group_comms or []
        self.phase = PHASE1
        self.barrier_requested = False
        self.minibatch = 0
        self.op_idx = 0                 # op position within the minibatch
        self.outstanding: List[Tuple[str, int]] = []
        self.pending_meta: List[int] = []   # meta seqs not yet examined
        self.acquired_at_mb: Optional[int] = None
        self.blocked_on: Optional[Tuple[str, int]] = None
        self.saw_all_acked = False

    # -- external command ----------------------------------------------------
    def request_barrier(self) -> None:
        self.barrier_requested = True

    # -- helpers --------------------------------------------------------------
    def _meta_payload(self) -> Tuple[int, int]:
        need = 1 if self.barrier_requested else 0
        ack = 1 if self.phase == PHASE2 else 0
        return (need, ack)

    def _drain_meta_results(self) -> None:
        remaining = []
        for seq in self.pending_meta:
            if self.engine.is_complete("meta", seq):
                need, ack = self.engine.result("meta", seq)
                if need > 0 and self.phase == PHASE1:
                    self.phase = PHASE2
                if ack == self.engine.world:
                    self.saw_all_acked = True
            else:
                remaining.append(seq)
        self.pending_meta = remaining

    def _drain_outstanding(self) -> bool:
        self.outstanding = [(c, s) for (c, s) in self.outstanding
                            if not self.engine.is_complete(c, s)]
        return not self.outstanding

    @property
    def done(self) -> bool:
        return self.phase == ACQUIRED

    # -- one scheduling quantum ------------------------------------------------
    def step(self) -> bool:
        """Advance by at most one action.  Returns True if progress was made."""
        if self.done:
            return False
        self._drain_meta_results()

        # synchronous mode / sync point blocking
        if self.blocked_on is not None:
            if self.engine.is_complete(*self.blocked_on):
                self.blocked_on = None
            else:
                return False

        # acquire check: phase 2, everyone acked, nothing in flight for us
        if self.phase == PHASE2 and self.saw_all_acked:
            self._drain_meta_results()
            if self._drain_outstanding() and not self.pending_meta:
                self.phase = ACQUIRED
                self.acquired_at_mb = self.minibatch
                return True
            # wait for drains
            if self.outstanding:
                self.blocked_on = self.outstanding[0]
            elif self.pending_meta:
                self.blocked_on = ("meta", self.pending_meta[0])
            return True

        n_ops = self.n_collectives
        sync_mode = self.phase == PHASE2

        if self.op_idx < n_ops:
            i = self.op_idx
            if self.mode == "per_allreduce":
                mseq = self.engine.issue("meta", self.rank, self._meta_payload())
                self.pending_meta.append(mseq)
                dseq = self.engine.issue("data", self.rank, (0,))
                self.outstanding.append(("data", dseq))
                if sync_mode:
                    self.blocked_on = ("data", dseq)
            else:  # minibatch_end: intra-MB collectives on group comms
                comm = self.group_comms[i % len(self.group_comms)] \
                    if self.group_comms else "data"
                dseq = self.engine.issue(comm, self.rank, (0,))
                self.outstanding.append((comm, dseq))
                if sync_mode:
                    self.blocked_on = (comm, dseq)
            self.op_idx += 1
            return True

        # end of mini-batch: sync point (cudaStreamWaitEvent analogue)
        if not self._drain_outstanding():
            self.blocked_on = self.outstanding[0]
            return True
        if self.mode == "minibatch_end":
            mseq = self.engine.issue("meta", self.rank, self._meta_payload())
            self.pending_meta.append(mseq)
            if sync_mode or self.barrier_requested:
                self.blocked_on = ("meta", mseq)
        self.minibatch += 1
        self.op_idx = 0
        return True


# ---------------------------------------------------------------------------
# Simulation driver
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BarrierResult:
    acquired: bool
    minibatches_to_acquire: int     # max over workers since command delivery
    steps: int
    consistent_cut: bool
    issue_counts: Dict[str, List[int]]


def run_barrier_simulation(world_size: int, n_collectives: int,
                           command_at_step: int, schedule_seed: int,
                           mode: str = "per_allreduce",
                           n_groups: int = 2,
                           max_steps: int = 200_000) -> BarrierResult:
    """Run workers under a seeded adversarial interleaving until all acquire."""
    engine = CollectiveEngine(world_size)
    engine.register("meta")
    engine.register("data")
    group_comms = []
    if mode == "minibatch_end":
        for g in range(n_groups):
            name = f"group{g}"
            engine.register(name)
            group_comms.append(name)
    workers = [BarrierWorker(r, engine, n_collectives, mode, group_comms)
               for r in range(world_size)]

    rng = np.random.Generator(np.random.Philox(schedule_seed))
    steps = 0
    command_sent = False
    mb_at_command = [0] * world_size
    while not all(w.done for w in workers) and steps < max_steps:
        if steps >= command_at_step and not command_sent:
            for w in workers:
                w.request_barrier()
                mb_at_command[w.rank] = w.minibatch
            command_sent = True
        order = rng.permutation(world_size)
        progressed = False
        for idx in order:
            if workers[idx].step():
                progressed = True
                break  # one action per quantum -> fine-grained interleaving
        steps += 1
        if not progressed and command_sent is False:
            break

    acquired = all(w.done for w in workers)
    counts = {c: engine.issue_counts(c) for c in engine.comms}
    consistent = acquired
    for comm in engine.comms:
        cs = engine.issue_counts(comm)
        if len(set(cs)) != 1 or engine.in_flight(comm) != 0:
            consistent = False
    mbs = max((w.acquired_at_mb or 0) - mb_at_command[w.rank] for w in workers) \
        if acquired else -1
    return BarrierResult(acquired=acquired, minibatches_to_acquire=mbs,
                         steps=steps, consistent_cut=consistent,
                         issue_counts=counts)
