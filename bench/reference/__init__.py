"""Plain references of the benchmark's configurations, one module a
family; a configuration names its module in its ``reference`` block.

A family module is the one place for everything about its family:

- ``train(model, semantics, optim, initial, paths, batches, splice,
  matmul)``: the plain f32 reference of the job's first steps (see
  ``transformer.train``);
- ``layout(model)``: the port's parameter tree of the configuration, as
  nested dicts of shapes written from the published description;
- ``DRAWS`` (optional): the leaves, by last name, drawn by a rule of
  ``weights.MENU`` in place of the default;
- ``step_flops(model, tokens_per_row, rows)`` (optional): a step's model
  FLOPs for ``step_mfu.train``, in place of ``costs.step_flops``.
"""
from __future__ import annotations

import importlib


def load(config: dict):
    """The reference module a configuration's file names."""
    return importlib.import_module(
        f"bench.reference.{config['reference']['module']}")
