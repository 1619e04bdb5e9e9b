"""Elastic runtime: transparent resize of a live job (§5) (port of
``repro.core.elastic``).

To the job, the world size W never changes.  The runtime maps W logical
ranks onto P physical devices; resizing swaps the splice factor s = W/P in
the step it runs: the training state is untouched (work-conserving), the
data pipeline cursor is untouched, and the trajectory is invariant up to
the order of f32 sums (tested).

ZeRO partial sharding (§5.4): a job whose optimizer state is sharded
``zero_shard_factor``-way can only be spliced up to W / shard_factor; the
runtime enforces the paper's placement rule.

Every physical rank of the job is time-sliced onto the one ``device``
here: the step runs the s slices of the global batch in turn, as the JAX
step scans over them.  The sharded step over a ``DeviceMesh`` is the same
``build_train_step`` on DTensors (``parallel/``); the card runs see one
device.

``donate=True`` runs the donated step (``training/step.py``): the same
update writes the state in place, 16 bytes a parameter where the
functional step, which writes a new state, holds 28 at its update.  JAX's
runtime does not donate, so the functional step stays the default.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import train_state_from_jax, train_state_to_numpy
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.barrier_step import BarrierDriver
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.frontend import synth_extra_inputs
from repro_torch.optim.zero import validate_partial_sharding
from repro_torch.training.state import TrainState, init_train_state
from repro_torch.training.step import build_train_step
from repro_torch.utils import resolve_device
from repro_torch.utils.spans import span
from repro_torch.utils.tree import tree_map


def _check_divides(world_size: int, physical: int) -> None:
    if physical < 1 or world_size % physical:
        raise ValueError(f"world {world_size} is not divisible by "
                         f"{physical} physical devices")


class ElasticRuntime:
    """Host-side elastic training driver on one device.

    ``state`` (a train state tree of tensors) and ``pipeline_state`` resume
    a job; otherwise the state is drawn from ``tcfg.seed``, as the JAX
    runtime draws it from ``PRNGKey(tcfg.seed)`` (``seed`` is kept for the
    JAX signature and, as there, unused).

    The audio and VLM families take frame or patch embeddings beside the
    tokens.  As the JAX runtime draws them once, from ``PRNGKey(tcfg.seed
    + 1)``, and puts the same arrays in every batch, this one draws them
    once from a generator seeded with ``tcfg.seed + 1`` (other values than
    JAX's), unless the caller passes ``extra_inputs``, a dict of arrays
    with the global batch as their leading axis (JAX's, for example).  The
    step slices them with the tokens.
    """

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, world_size: int,
                 physical_devices: int, global_batch: int, seq_len: int,
                 seed: int = 0, state: Optional[TrainState] = None,
                 pipeline_state: Optional[Dict] = None, *, device="cuda",
                 extra_inputs: Optional[Dict] = None, donate: bool = False):
        _check_divides(world_size, physical_devices)
        self.cfg = cfg
        self.tcfg = tcfg
        self.device = resolve_device(device)
        self.world_size = world_size
        self.physical = physical_devices
        self.donate = donate
        validate_partial_sharding(world_size, tcfg.zero_shard_factor,
                                  world_size // physical_devices)
        self.pipeline = DataPipeline(cfg.vocab_size, seq_len, global_batch,
                                     world_size, seed=tcfg.seed)
        if pipeline_state:
            self.pipeline.restore(pipeline_state)
        self.state = state if state is not None else init_train_state(
            cfg, tcfg, tcfg.seed, device=self.device)
        self.barrier = BarrierDriver(n_shards=1)
        if extra_inputs is None:
            extra_inputs = synth_extra_inputs(cfg, global_batch,
                                              tcfg.seed + 1,
                                              device=self.device)
        self.extra_inputs = {
            key: (val if torch.is_tensor(val)
                  else torch.from_numpy(np.array(val))).to(self.device)
            for key, val in extra_inputs.items()}
        self._steps: Dict[int, Callable] = {}
        self.history: List[Dict] = []

    # ------------------------------------------------------------------ step
    @property
    def splice(self) -> int:
        return self.world_size // self.physical

    def _step_fn(self) -> Callable:
        s = self.splice
        if s not in self._steps:
            self._steps[s] = build_train_step(self.cfg, self.tcfg, splice=s,
                                              with_barrier=True,
                                              donate=self.donate)
        return self._steps[s]

    # ----------------------------------------------------- preemption flow
    def request_preemption(self) -> None:
        """Scheduler command: quiesce at the next safe boundary (§4).  The
        (need, ack) payload rides the job's own step."""
        self.barrier.request()

    @property
    def quiesced(self) -> bool:
        return self.barrier.acquired

    def _batch(self) -> Dict:
        tokens, labels = self.pipeline.next_batch()
        return {"tokens": torch.as_tensor(tokens, dtype=torch.long,
                                          device=self.device),
                "labels": torch.as_tensor(labels, dtype=torch.long,
                                          device=self.device),
                **self.extra_inputs}

    def run_steps(self, n: int, stop_on_barrier: bool = False) -> List[Dict]:
        """Run ``n`` steps; each record has the JAX runtime's keys plus the
        step's ``grad_norm``."""
        out = []
        fn = self._step_fn()
        for _ in range(n):
            with span("elastic.step"):
                batch = self._batch()
                self.state, metrics = fn(self.state, batch,
                                         self.barrier.flags(self.device))
                acquired = self.barrier.observe(metrics["barrier"])
                rec = {"step": int(self.state["step"]),
                       "loss": float(metrics["loss"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "splice": self.splice,
                       "physical": self.physical,
                       "barrier_acquired": acquired}
            out.append(rec)
            self.history.append(rec)
            if acquired and stop_on_barrier:
                break
        return out

    # ---------------------------------------------------------------- resize
    def resize(self, new_physical: int) -> Dict:
        """Transparent resize: same logical world, new physical mapping.

        Work-conserving by construction: state and data cursor unchanged.
        """
        _check_divides(self.world_size, new_physical)
        validate_partial_sharding(self.world_size, self.tcfg.zero_shard_factor,
                                  self.world_size // new_physical)
        old = self.physical
        t0 = time.time()
        self.physical = new_physical
        self._step_fn()     # build the new splice's step
        return {"from": old, "to": new_physical,
                "splice": self.splice,
                "resize_seconds": time.time() - t0,
                "at_step": int(self.state["step"])}

    # ------------------------------------------------------------- snapshots
    def snapshot(self) -> Dict:
        """The complete program state (work-conserving checkpoint payload),
        as numpy on the host, in the JAX runtime's layout.  Its arrays are
        copies: a donated step writes the state in place, and numpy views
        of CPU tensors would see it."""
        state = train_state_to_numpy(self.state)
        if self.donate:
            state = tree_map(np.copy, state)
        return {
            "state": state,
            "pipeline": self.pipeline.snapshot(),
            "world_size": self.world_size,
        }

    @classmethod
    def from_snapshot(cls, cfg: ModelConfig, tcfg: TrainConfig, snap: Dict,
                      physical_devices: int, global_batch: int, seq_len: int,
                      *, device="cuda", donate: bool = False
                      ) -> "ElasticRuntime":
        """A runtime resumed from ``snapshot()``'s payload, or from a
        checkpoint: ``state`` one worker's tree of numpy arrays as
        ``CheckpointStore.restore`` returns it (in the manifest's or the
        template's key order), ``pipeline`` and ``world_size`` from that
        worker's host state."""
        dev = resolve_device(device)
        state = train_state_from_jax(snap["state"], cfg, device=dev)
        return cls(cfg, tcfg, snap["world_size"], physical_devices,
                   global_batch, seq_len, state=state,
                   pipeline_state=snap["pipeline"], device=dev,
                   donate=donate)
