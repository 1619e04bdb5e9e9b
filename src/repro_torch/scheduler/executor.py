"""Fleet executor: the hierarchical scheduler driving REAL jobs (port of
``repro.scheduler.executor``).

Where ``simulator.py`` models jobs as progress rates, this executor runs a
miniature fleet of actual ``ElasticRuntime`` training jobs (reduced
configs) and applies the scheduling decisions through the REAL
mechanisms: resize -> spliced-step swap; preempt -> in-graph barrier
quiesce + content-deduped checkpoint; re-admit -> restore + resume.
Figure 1's scopes as running code, on one host.

The decisions come from the SAME ``ElasticPolicy.decide`` the simulator
exercises — the executor adapts its slot capacity to a one-cluster
``Fleet`` and mirrors each managed job as a scheduler ``Job`` (the
workload-scope shadow: arrival order, SLA account, allocation state).
The shadows' SLA accounts live in the same ``FleetSLAAccounts`` ledger
the simulator uses, recorded in one batched call per tick, and the
shadows themselves are adopted into the same fleet ``JobTable`` — the
policy slices identical columns under both back-ends.  One policy, two
mechanism back-ends; simulated results and real-mechanism results can no
longer drift apart.

Capacity is counted in "device slots"; each job's logical world size stays
constant while its physical allocation follows the policy, rounded to the
nearest world-size divisor (the splice constraint s = W/P).

The port's executor is the JAX one with a ``device``: every job's
``ElasticRuntime``, fresh or restored from the store, runs on it (default
``cuda``, which raises where there is no card).  The decisions depend on
no wall time and no loss, so the ``(event, job, at_step)`` log is the same
on any device and under either package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.checkpoint import CheckpointStore
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.core.migration import checkpoint_job
from repro_torch.core.sla import FleetSLAAccounts, FleetSlotAccount
from repro_torch.scheduler.costs import CostModel
from repro_torch.scheduler.job_table import TIER_CODE, JobTable, TableJob
from repro_torch.scheduler.node_map import NodeMap
from repro_torch.scheduler.policy import ElasticPolicy
from repro_torch.scheduler.telemetry import (
    C_FAILURE,
    C_NONE,
    C_POLICY,
    C_PREEMPT,
    E_ADMIT,
    E_COMPLETE,
    E_FAILURE,
    E_PREEMPT,
    E_RESIZE,
    E_RESTORE,
    FleetTelemetry,
)
from repro_torch.scheduler.types import Cluster, Fleet, Job, Region
from repro_torch.utils import resolve_device


@dataclasses.dataclass
class ManagedJob:
    id: str
    tier: str
    arch: str
    world_size: int  # logical (constant) = demanded devices
    total_steps: int
    runtime: Optional[ElasticRuntime] = None
    allocated: int = 0
    done: bool = False
    preemptions: int = 0
    resizes: int = 0
    steps_done: int = 0

    def demand(self) -> int:
        return self.world_size


def _largest_divisor_leq(world: int, cap: int) -> int:
    """Largest physical device count that divides ``world`` and is <= cap."""
    give = min(world, cap)
    while give > 0 and world % give != 0:
        give -= 1
    return give


class FleetExecutor:
    """A single-host fleet of real elastic jobs under tiered scheduling."""

    def __init__(
        self,
        total_slots: int,
        seed: int = 0,
        policy: Optional[ElasticPolicy] = None,
        tick_seconds: float = 60.0,
        cost_model: Optional[CostModel] = None,
        telemetry: Optional[FleetTelemetry] = None,
        *,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.total_slots = total_slots
        self.jobs: Dict[str, ManagedJob] = {}
        self.store = CheckpointStore()
        self.log: List[Dict] = []
        # observability: the same structured event log / profiler bundle
        # the simulator threads (telemetry.py) — pass ``True`` to build a
        # fresh one.  ``self.log``'s human-readable dicts stay; the
        # structured rows add machine-checkable lifecycle events on the
        # REAL-mechanism back-end too.
        if telemetry is True:
            telemetry = FleetTelemetry()
        self.tele: Optional[FleetTelemetry] = telemetry or None
        self._ev = self.tele.events if self.tele is not None else None
        # the same policy object the simulator drives, over a 1-cluster fleet
        self.policy = policy or ElasticPolicy()
        # thread the mechanism cost model into the policy so the executor's
        # decisions price preempt/restore/resize exactly like the simulator
        self.cost_model = cost_model or CostModel()
        if hasattr(self.policy, "bind_costs"):
            self.policy.bind_costs(self.cost_model, tick_seconds)
        if self.tele is not None and hasattr(self.policy, "bind_telemetry"):
            self.policy.bind_telemetry(self.tele)
        # shadow accounts live in a shared fleet ledger, and the shadows
        # themselves in a shared JobTable, like the simulator's — one
        # decide path for both back-ends, column slices included
        self.sla = FleetSLAAccounts()
        self.table = JobTable(clusters=["local"], sla=self.sla)
        self.fleet = Fleet(
            [Region("local", [Cluster("local", "local", total_slots)])],
            sla=self.sla,
            jobs=self.table,
        )
        # shadows carry real node spans: the policy's gang/splice-aware
        # node placement sees the same NodeMap shape the simulator would,
        # so its divisor rounding matches the executor's splice constraint
        self.fleet.node_map = NodeMap.from_fleet(self.fleet)
        self.tick_seconds = tick_seconds
        self.clock = 0.0
        self._shadows: Dict[str, Job] = {}  # workload-scope policy mirrors

    # ------------------------------------------------------------ admission
    def submit(
        self, job: ManagedJob, global_batch: int = 8, seq_len: int = 32
    ) -> None:
        cfg = get_smoke_config(job.arch)
        tcfg = TrainConfig(
            total_steps=job.total_steps, warmup_steps=1, learning_rate=1e-3
        )
        job.runtime = ElasticRuntime(
            cfg,
            tcfg,
            job.world_size,
            job.world_size,
            global_batch,
            seq_len,
            device=self.device,
        )
        job._cfg, job._tcfg = cfg, tcfg
        job._gb, job._sl = global_batch, seq_len
        self.jobs[job.id] = job
        # scheduler-facing mirror: demand = logical world, splice floor 1;
        # adopted into the shared JobTable so the policy's decide path
        # slices the same columns it would under the simulator
        shadow = Job(
            id=job.id,
            tier=job.tier,
            demand_gpus=job.world_size,
            gpu_hours=job.total_steps * job.world_size / 3600.0,
            arrival=self.clock,
            min_gpus=1,
            account=FleetSlotAccount(self.sla, job.tier, job.world_size),
        )
        shadow.node_slot = self.table.adopt(shadow)  # NodeMap row == slot
        self._shadows[job.id] = shadow

    def _emit(
        self,
        kind: int,
        jid: str,
        cause: int = C_NONE,
        gpus: int = 0,
        seconds: float = 0.0,
    ) -> None:
        """One structured telemetry row for this managed job (no-op when
        no telemetry is attached).  Jobs are keyed by their stable table
        slot; the one-cluster fleet is cluster index 0.  ``seconds`` is
        the mechanism's modelled cost — the executor measures steps, not
        wall downtime, so FAILURE rows carry lost *steps* instead."""
        if self._ev is None:
            return
        s = self._shadows[jid]
        self._ev.append(
            self.clock,
            kind,
            job=s.node_slot,
            cluster=0,
            tier=TIER_CODE[s.tier],
            cause=cause,
            gpus=gpus,
            seconds=seconds,
        )

    # ------------------------------------------------------------ policy
    def _decide_allocations(self) -> Dict[str, int]:
        """Run the unified ``ElasticPolicy`` over the one-cluster fleet and
        round each target to the splice constraint (divisor of world)."""
        shadows = [self._shadows[jid] for jid, j in self.jobs.items() if not j.done]
        decision = self.policy.decide(self.clock, shadows, self.fleet)
        alloc: Dict[str, int] = {}
        free = self.total_slots
        for s in sorted(shadows, key=lambda s: -decision.alloc[s.id][0]):
            target, _ = decision.alloc[s.id]
            give = _largest_divisor_leq(self.jobs[s.id].world_size, min(target, free))
            alloc[s.id] = give
            free -= give
        return alloc

    def _apply(self, alloc: Dict[str, int]) -> None:
        for jid, target in alloc.items():
            job = self.jobs[jid]
            if job.done:
                continue
            if target == job.allocated:
                continue
            if target == 0 and job.allocated > 0:
                # REAL preemption: in-graph barrier quiesce + checkpoint
                job.runtime.request_preemption()
                job.runtime.run_steps(2, stop_on_barrier=True)
                job.steps_done = int(job.runtime.state["step"])
                checkpoint_job(job.runtime, self.store, jid)
                job.runtime = None
                job.preemptions += 1
                # the shadow carries the preempt cost as restore debt, so
                # the policy's restart gates price this job's re-admission
                # exactly like the simulator would; it also re-enters the
                # queue now, which is when fairness aging starts accruing
                shadow = self._shadows[jid]
                debt = self.cost_model.preempt_seconds(shadow.checkpoint_bytes)
                shadow.restore_debt += debt
                shadow.queued_since = self.clock
                self.log.append({"event": "preempt", "job": jid})
                self._emit(
                    E_PREEMPT,
                    jid,
                    cause=C_POLICY,
                    gpus=job.allocated,
                    seconds=debt,
                )
            elif target > 0 and job.allocated == 0 and job.runtime is None:
                if jid not in self.store.manifests:
                    # failed before any checkpoint existed: fresh restart
                    job.runtime = ElasticRuntime(
                        job._cfg,
                        job._tcfg,
                        job.world_size,
                        target,
                        job._gb,
                        job._sl,
                        device=self.device,
                    )
                    job.steps_done = 0
                    shadow = self._shadows[jid]
                    failed = shadow.failed_at is not None
                    shadow.failed_at = None
                    self.log.append({"event": "restart", "job": jid, "at_step": 0})
                    self._emit(
                        E_ADMIT,
                        jid,
                        cause=C_FAILURE if failed else C_NONE,
                        gpus=target,
                    )
                    job.allocated = target
                    shadow.allocated = target
                    shadow.ever_ran = True
                    shadow.cluster = "local"
                    continue
                # REAL re-admission: restore from the deduped store
                failed = self._shadows[jid].failed_at is not None
                self._shadows[jid].restore_debt = 0.0
                self._shadows[jid].failed_at = None
                device, host, step = self.store.restore(jid)
                job.runtime = ElasticRuntime.from_snapshot(
                    job._cfg,
                    job._tcfg,
                    {
                        "state": device[0],
                        "pipeline": host[0]["pipeline"],
                        "world_size": host[0]["world_size"],
                    },
                    target,
                    job._gb,
                    job._sl,
                    device=self.device,
                )
                assert int(job.runtime.state["step"]) == job.steps_done
                self.log.append({"event": "restore", "job": jid, "at_step": step})
                self._emit(
                    E_RESTORE,
                    jid,
                    cause=C_FAILURE if failed else C_PREEMPT,
                    gpus=target,
                    seconds=self.cost_model.restore_seconds(
                        self._shadows[jid].checkpoint_bytes
                    ),
                )
            elif target > 0 and job.runtime is not None:
                if job.runtime.physical != target:
                    job.runtime.resize(target)  # REAL transparent resize
                    if job.allocated > 0:  # admission is not a resize
                        job.resizes += 1
                        self.log.append({"event": "resize", "job": jid, "to": target})
                        self._emit(
                            E_RESIZE,
                            jid,
                            cause=C_POLICY,
                            gpus=target,
                            seconds=self.cost_model.resize_seconds(
                                self._shadows[jid].checkpoint_bytes
                            ),
                        )
                if job.allocated == 0:
                    self._emit(E_ADMIT, jid, gpus=target)
            job.allocated = target
            shadow = self._shadows[jid]
            shadow.allocated = target
            if target > 0:
                shadow.ever_ran = True
                shadow.cluster = "local"
        self._sync_node_spans()

    def _sync_node_spans(self) -> None:
        """Mirror the applied slot allocations into the fleet NodeMap so
        the next decide pass plans against real node spans (row == table
        slot; the one-cluster fleet auto-fits lowest-index first)."""
        nm = self.fleet.node_map
        for s in self._shadows.values():
            if s.done_at is not None:
                continue
            g = int(s.allocated)
            if nm.span_total(s.node_slot) == g:
                continue
            nm.release(s.node_slot)
            if g > 0:
                nm.auto_fit(s.node_slot, 0, g)

    # ------------------------------------------------------------ faults
    def inject_failure(self, jid: str) -> Dict:
        """Unplanned hardware failure under the REAL mechanisms: the
        runtime is dropped with NO graceful checkpoint, so the job loses
        every step since its last durable snapshot in the store and
        restarts from there (or from step 0 if it never checkpointed) at
        the next admission — the paper's reliability claim (§1, §6):
        a failure is just a preemption minus the barrier.
        """
        job = self.jobs[jid]
        assert not job.done, "cannot fail a completed job"
        step_now = job.steps_done
        if job.runtime is not None:
            step_now = int(job.runtime.state["step"])
        if jid in self.store.manifests:
            snap_step = int(self.store.manifests[jid][-1]["step"])
        else:
            snap_step = 0  # never checkpointed: restart from scratch
        job.runtime = None  # the hardware is gone — no quiesce, no dump
        lost_alloc = job.allocated
        job.allocated = 0
        job.steps_done = snap_step
        shadow = self._shadows[jid]
        shadow.allocated = 0
        self.fleet.node_map.release(shadow.node_slot)
        shadow.failures += 1
        shadow.failed_at = self.clock
        shadow.queued_since = self.clock  # fairness aging restarts here
        shadow.restore_debt = 0.0  # no graceful preempt was paid
        event = {
            "event": "failure",
            "job": jid,
            "at_step": step_now,
            "rollback_to": snap_step,
            "lost_steps": step_now - snap_step,
        }
        self.log.append(event)
        self._emit(
            E_FAILURE,
            jid,
            cause=C_FAILURE,
            gpus=lost_alloc,
            seconds=float(step_now - snap_step),  # lost STEPS (see _emit)
        )
        return event

    # ------------------------------------------------------------ run
    def tick(self, steps: int = 1) -> None:
        """One scheduling round: decide, apply, advance running jobs."""
        self._apply(self._decide_allocations())
        # the shadows' SLA accounts see the interval we are about to run —
        # one batched record into the fleet ledger
        live = [s for s in self._shadows.values() if s.done_at is None]
        if live:
            slots = np.array([s.account.ensure_slot() for s in live], np.int64)
            m = len(live)
            self.sla.record_batch(
                slots,
                np.full(m, self.clock),
                np.full(m, self.clock + self.tick_seconds),
                np.array([s.allocated for s in live], np.int64),
            )
        self.clock += self.tick_seconds
        for job in self.jobs.values():
            if job.done or job.runtime is None or job.allocated == 0:
                continue
            job.runtime.run_steps(steps)
            job.steps_done = int(job.runtime.state["step"])
            if job.steps_done >= job.total_steps:
                job.done = True
                self._emit(E_COMPLETE, job.id, gpus=job.allocated)
                job.allocated = 0
                job.runtime = None
                shadow = self._shadows[job.id]
                shadow.done_at = self.clock
                shadow.allocated = 0
                shadow.account.release()
                self.fleet.node_map.release(shadow.node_slot)
                if isinstance(shadow, TableJob):
                    self.table.detach(shadow)  # row freed for reuse
                self.log.append(
                    {"event": "done", "job": job.id, "steps": job.steps_done}
                )

    def run(self, max_ticks: int = 100) -> List[Dict]:
        for _ in range(max_ticks):
            if all(j.done for j in self.jobs.values()):
                break
            self.tick()
        return self.log
