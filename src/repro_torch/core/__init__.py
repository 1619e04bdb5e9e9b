"""Singularity's core mechanisms (port of ``repro.core``), so far:

- ``barrier``      — the tandem meta-allreduce distributed barrier's
  protocol engine (§4.3.1), a copy of ``repro.core.barrier`` (numpy);
- ``barrier_step`` — the same 2-int protocol carried by the train step,
  counterpart of ``repro.core.barrier_jax``;
- ``checkpoint``   — content-deduped consistent checkpoints (§4, §4.6);
- ``elastic``      — the transparent elastic runtime over the spliced step
  (§5);
- ``migration``    — preempt -> dump -> transfer -> restore (§4.5);
- ``sla``          — GPU-fraction SLA tiers and accounting (§2.5), a copy
  of ``repro.core.sla`` (numpy).

The device proxy, buffers, splicing engine and squash validation of
``repro.core`` are numpy models that the port has not copied yet
(ROADMAP M10).
"""
import importlib

# Names resolve lazily (PEP 562): ``elastic`` imports the training step,
# which imports ``barrier_step`` from this package, so importing them here
# eagerly would make a cycle.
_LAZY = {
    "BarrierResult": "barrier",
    "BarrierWorker": "barrier",
    "CollectiveEngine": "barrier",
    "run_barrier_simulation": "barrier",
    "BarrierDriver": "barrier_step",
    "meta_allreduce": "barrier_step",
    "CheckpointStore": "checkpoint",
    "SnapshotStats": "checkpoint",
    "ElasticRuntime": "elastic",
    "MigrationReport": "migration",
    "checkpoint_job": "migration",
    "migrate": "migration",
    "TIERS": "sla",
    "FleetSLAAccounts": "sla",
    "FleetSlotAccount": "sla",
    "GpuFractionAccount": "sla",
    "SLATier": "sla",
}


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f"repro_torch.core.{_LAZY[name]}")
        val = getattr(mod, name)
        globals()[name] = val
        return val
    raise AttributeError(f"module 'repro_torch.core' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
