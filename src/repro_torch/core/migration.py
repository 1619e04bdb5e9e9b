"""Transparent migration & resizing flow (§4.5, Table 5) (port of
``repro.core.migration``).

End-to-end: acquire barrier -> dump (device + host state, deduped) ->
upload -> download -> restore -> fresh rendezvous -> resume.  The dump
(device to host, serialize, checksum) and the restore (deserialize, host
to device, the destination's step) are measured on the host's clock; the
barrier is the protocol engine's count of mini-batches times a step's
time; the blob-store transfer is modelled as bytes / bandwidth
(``utils/constants.py``), as in the JAX package, mirroring how the paper
reports Transfer as the dominant component.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.barrier import run_barrier_simulation
from repro_torch.core.checkpoint import CheckpointStore, SnapshotStats
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.utils import constants, resolve_device


@dataclasses.dataclass
class MigrationReport:
    job_id: str
    from_physical: int
    to_physical: int
    barrier_seconds: float
    barrier_minibatches: int
    dump_seconds: float
    upload_seconds: float
    download_seconds: float
    restore_seconds: float
    total_seconds: float
    device_stored_bytes: int
    host_stored_bytes: int
    work_conserving: bool       # resumed at exactly the preempted step
    src_region: Optional[str] = None    # region pair the transfer crossed
    dst_region: Optional[str] = None

    def transfer_seconds(self) -> float:
        return self.upload_seconds + self.download_seconds


def checkpoint_job(runtime: ElasticRuntime, store: CheckpointStore,
                   job_id: str) -> SnapshotStats:
    """Consistent checkpoint of all W logical workers.

    DP replicas carry identical params/optimizer state — the content-
    addressed store dedups them so stored device bytes are independent of W
    (Table 4).  Host state (data cursor, step) is per-worker.
    """
    snap = runtime.snapshot()
    device_by_worker = {w: snap["state"] for w in range(runtime.world_size)}
    host_by_worker = {w: {"pipeline": snap["pipeline"],
                          "world_size": snap["world_size"],
                          "rank": w}
                      for w in range(runtime.world_size)}
    return store.snapshot(job_id, int(runtime.state["step"]),
                          device_by_worker, host_by_worker)


def migrate(runtime: ElasticRuntime, store: CheckpointStore, job_id: str,
            to_physical: int, cfg: ModelConfig, tcfg: TrainConfig,
            global_batch: int, seq_len: int,
            per_step_seconds: float = 0.5,
            blob_bandwidth: float = constants.BLOB_STORE_BANDWIDTH,
            barrier_seed: int = 0,
            topology=None, src_region: str = None,
            dst_region: str = None, *, device="cuda") -> tuple:
    """Preempt ``runtime`` and resume it on ``to_physical`` devices of the
    destination, on ``device``.

    When a topology (any object with ``bandwidth(src, dst)`` and
    ``latency_seconds(src, dst)``, as the scheduler's ``RegionTopology``)
    and a (source, destination) region pair are given, the modelled blob
    transfer runs at that pair's link bandwidth plus its first-byte
    latency — the same tiers the scheduler's ``CostModel`` charges, so
    measured reports and fleet-wide pricing stay calibrated against each
    other (``CostModel.from_reports``).

    Returns (new_runtime, MigrationReport).
    """
    dev = resolve_device(device)
    step_before = int(runtime.state["step"])
    transfer_latency = 0.0
    if topology is not None:
        blob_bandwidth = topology.bandwidth(src_region, dst_region)
        transfer_latency = topology.latency_seconds(src_region, dst_region)

    # 1. barrier: the distributed-protocol cost in mini-batches (from the
    #    faithful protocol engine), converted to wall time
    bres = run_barrier_simulation(
        world_size=runtime.world_size, n_collectives=4,
        command_at_step=3, schedule_seed=barrier_seed)
    assert bres.acquired and bres.consistent_cut
    barrier_s = bres.minibatches_to_acquire * per_step_seconds

    # 2. dump
    t0 = time.time()
    stats = checkpoint_job(runtime, store, job_id)
    dump_s = time.time() - t0

    # 3. transfer (modelled: the paper uploads to/downloads from blob
    #    store; a cross-region pair pays its slower link + first byte)
    total_bytes = stats.device_stored_bytes + stats.host_stored_bytes
    upload_s = total_bytes / blob_bandwidth
    download_s = total_bytes / blob_bandwidth + transfer_latency

    # 4. restore on the destination (fresh device proxies + replay; here:
    #    fresh runtime + state load + step build = the rendezvous)
    t0 = time.time()
    device_trees, host, step = store.restore(job_id)
    new_runtime = ElasticRuntime.from_snapshot(
        cfg, tcfg,
        {"state": device_trees[0], "pipeline": host[0]["pipeline"],
         "world_size": host[0]["world_size"]},
        to_physical, global_batch, seq_len, device=dev)
    del device_trees
    new_runtime._step_fn()      # build the destination's step
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    restore_s = time.time() - t0

    work_conserving = int(new_runtime.state["step"]) == step_before
    report = MigrationReport(
        job_id=job_id, from_physical=runtime.physical,
        to_physical=to_physical, barrier_seconds=barrier_s,
        barrier_minibatches=bres.minibatches_to_acquire,
        dump_seconds=dump_s, upload_seconds=upload_s,
        download_seconds=download_s, restore_seconds=restore_s,
        total_seconds=barrier_s + dump_s + upload_s + download_s + restore_s,
        device_stored_bytes=stats.device_stored_bytes,
        host_stored_bytes=stats.host_stored_bytes,
        work_conserving=work_conserving,
        src_region=src_region, dst_region=dst_region)
    return new_runtime, report
