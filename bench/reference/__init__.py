"""Plain references of the benchmark's configurations, one module a
family; a configuration names its module in its ``reference`` block."""
from __future__ import annotations

import importlib


def load(config: dict):
    """The reference module a configuration's file names."""
    return importlib.import_module(
        f"bench.reference.{config['reference']['module']}")
