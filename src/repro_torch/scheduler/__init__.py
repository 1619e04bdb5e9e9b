"""The fleet scheduler (port of ``repro.scheduler``), so far:

- the numpy scheduler core, copies of the JAX package's modules
  (``curves``, ``costs``, ``types``, ``reliability``, ``telemetry``,
  ``job_table``, ``node_map``, ``policy``);
- the fleet simulator and the elastic serving tier (``simulator``,
  ``serving``), copies too; ``serving`` reads ``ReplicaProfile`` from the
  analytic half of ``repro_torch.serving.engine``;
- ``executor`` — the scheduler driving real jobs of the port's
  ``ElasticRuntime`` on a card (``FleetExecutor``, ``ManagedJob``);
- ``scenarios`` — the executor's three reference scenarios, for either
  executor's classes.

Names resolve lazily (PEP 562): the numpy core, the simulator and the
serving tier import without torch's model code, and ``executor`` is
loaded only when asked for.
"""
import importlib

_LAZY = {
    "CostModel": "costs",
    "RegionLink": "costs",
    "RegionTopology": "costs",
    "UniformCostModel": "costs",
    "FleetExecutor": "executor",
    "ManagedJob": "executor",
    "JobTable": "job_table",
    "JobView": "job_table",
    "TableJob": "job_table",
    "ElasticPolicy": "policy",
    "StaticGangPolicy": "policy",
    "CheckpointCadence": "reliability",
    "FailureEvent": "reliability",
    "FailureModel": "reliability",
    "FailureTrace": "reliability",
    "Cluster": "types",
    "Fleet": "types",
    "Job": "types",
    "Region": "types",
    "ServiceSpec": "serving",
    "ServingConfig": "serving",
    "ServingTier": "serving",
    "TrafficConfig": "serving",
    "TrafficTrace": "serving",
    "FleetSimulator": "simulator",
    "SimConfig": "simulator",
}


def __getattr__(name):
    if name in _LAZY:
        mod = importlib.import_module(f"repro_torch.scheduler.{_LAZY[name]}")
        val = getattr(mod, name)
        globals()[name] = val
        return val
    raise AttributeError(f"module 'repro_torch.scheduler' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))


__all__ = sorted(_LAZY)
