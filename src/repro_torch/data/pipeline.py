"""Deterministic, resumable, sharded synthetic token pipeline (a copy of
``repro.data.pipeline``, which is numpy only; the port keeps its own).


The pipeline is part of the job's *program state*: its cursor is captured in
the transparent checkpoint (DESIGN.md §2) so a resumed/migrated/resized job
continues on exactly the batch it would have seen — required for the
work-conserving property the paper claims.

Tokens are generated from a counter-mode PRNG keyed by (seed, step, logical
rank), so batch content is a pure function of the cursor — independent of
how many *physical* devices the job currently occupies.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int

    def to_dict(self) -> Dict:
        return {"seed": self.seed, "step": self.step}

    @staticmethod
    def from_dict(d: Dict) -> "PipelineState":
        return PipelineState(seed=int(d["seed"]), step=int(d["step"]))


class DataPipeline:
    """Yields (tokens, labels) for a fixed logical world size.

    ``global_batch`` rows per step, row r belongs to logical rank
    ``r * world_size // global_batch``.  ``batch_for_ranks`` returns the rows
    for any subset of logical ranks, which is what the elastic runtime uses
    when several logical ranks are spliced onto one physical device.
    """

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 world_size: int, seed: int = 0):
        assert global_batch % world_size == 0, (global_batch, world_size)
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.world_size = world_size
        self.per_rank = global_batch // world_size
        self.state = PipelineState(seed=seed, step=0)

    # -- deterministic content ------------------------------------------------
    def _rows(self, step: int, row_start: int, nrows: int) -> np.ndarray:
        """Counter-mode generation: each (step, row) is an independent stream."""
        out = np.empty((nrows, self.seq_len + 1), dtype=np.int32)
        for i in range(nrows):
            row = row_start + i
            rng = np.random.Generator(np.random.Philox(
                key=self.state.seed, counter=[0, 0, step, row]))
            out[i] = rng.integers(0, self.vocab_size, self.seq_len + 1,
                                  dtype=np.int32)
        return out

    def batch_for_ranks(self, ranks, step: int | None = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) for the given logical ranks at the given step."""
        step = self.state.step if step is None else step
        rows = []
        for r in ranks:
            start = r * self.per_rank
            rows.append(self._rows(step, start, self.per_rank))
        data = np.concatenate(rows, axis=0)
        return data[:, :-1], data[:, 1:]

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """Full global batch; advances the cursor."""
        tokens, labels = self.batch_for_ranks(range(self.world_size))
        self.state.step += 1
        return tokens, labels

    # -- checkpointable cursor ------------------------------------------------
    def snapshot(self) -> Dict:
        return self.state.to_dict()

    def restore(self, d: Dict) -> None:
        self.state = PipelineState.from_dict(d)
