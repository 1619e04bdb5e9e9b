"""Singularity's core mechanisms (port of ``repro.core``):

- ``barrier``      — the tandem meta-allreduce distributed barrier's
  protocol engine (§4.3.1), a copy of ``repro.core.barrier`` (numpy);
- ``barrier_step`` — the same 2-int protocol carried by the train step,
  counterpart of ``repro.core.barrier_jax``;
- ``buffers``      — the bidirectional allocator / device memory model
  (§5.2.2);
- ``checkpoint``   — content-deduped consistent checkpoints (§4, §4.6);
- ``device_proxy`` — interception, handle virtualization, log/replay (§3,
  §4.2);
- ``elastic``      — the transparent elastic runtime over the spliced step
  (§5);
- ``migration``    — preempt -> dump -> transfer -> restore (§4.5);
- ``sla``          — GPU-fraction SLA tiers and accounting (§2.5);
- ``splicing``     — the replica splicing engine (§5.1-§5.2);
- ``validation``   — conservative squash validation (§5.2.3).

``barrier``, ``buffers``, ``device_proxy``, ``sla``, ``splicing`` and
``validation`` are numpy models, copies of their ``repro.core`` modules.
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
    "Buffer": "buffers",
    "DeviceMemory": "buffers",
    "OutOfMemory": "buffers",
    "DeviceProxyClient": "device_proxy",
    "DeviceProxyServer": "device_proxy",
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
    "SplicedDevice": "splicing",
    "SplicedTrainer": "splicing",
    "SpliceMetrics": "splicing",
    "ValidationReport": "validation",
    "run_validated_training": "validation",
    "validate_squashing_window": "validation",
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
