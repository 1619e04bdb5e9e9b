"""The tandem meta-allreduce (§4.3.1) carried by the training step (port of
``repro.core.barrier_jax``).

The barrier protocol's state is two integers, (need_barrier, ack_barrier).
They travel with the job's own step: the step sums the payload over the
data shards and returns it with its metrics, so no out-of-band channel is
introduced.  Without a mesh one process holds every shard; under a mesh
the sum crosses the data axes as an all-reduce, JAX's ``psum``.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.parallel.constraints import is_dtensor


def meta_allreduce(flags: torch.Tensor, mesh=None,
                   data_axes: Sequence[str] = ("pod", "data")
                   ) -> torch.Tensor:
    """SUM-allreduce the 2-int (need, ack) payload across data shards.

    flags: (n_data_shards, 2) int32, the same on every rank (or a DTensor).
    Under a ``DeviceMesh`` its rows are sharded over the mesh's data axes
    and summed by an all-reduce.  Returns the summed (2,) payload, a plain
    tensor on every rank.
    """
    if mesh is None:
        return flags.sum(dim=0, dtype=torch.int32)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    names = list(mesh.mesh_dim_names)
    if not is_dtensor(flags):
        flags = distribute_tensor(flags, mesh, [
            Shard(0) if a in data_axes else Replicate() for a in names])
    summed = flags.sum(dim=0, dtype=torch.int32)
    return summed.redistribute(mesh, [Replicate()] * len(names)).to_local()


class BarrierDriver:
    """Host-side driver of the protocol carried by the step.

    Phase 1: each step carries (need, ack) = (0, 0): free.  On a preemption
    command the next step carries need=1; once the summed payload shows
    need > 0 every shard acks; when sum(ack) == n_shards the job is
    quiesced at the step boundary and can be checkpointed.
    """

    def __init__(self, n_shards: int):
        self.n = n_shards
        self.need = False
        self.acked = False
        self.acquired = False

    def request(self) -> None:
        self.need = True

    def flags(self, device="cpu") -> torch.Tensor:
        f = torch.zeros((self.n, 2), dtype=torch.int32)
        f[:, 0] = int(self.need)
        f[:, 1] = int(self.acked)
        return f.to(device)

    def observe(self, summed) -> bool:
        """Feed the summed payload from the step's metrics; returns True when
        the barrier is acquired (safe to checkpoint)."""
        need, ack = (int(x) for x in summed.tolist())
        if need > 0:
            self.acked = True
        if ack >= self.n:
            self.acquired = True
        return self.acquired

    def reset(self) -> None:
        """Release after the checkpoint is taken (resume normal running)."""
        self.need = self.acked = self.acquired = False
