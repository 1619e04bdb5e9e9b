"""PyTorch port of the ``repro`` package, for NVIDIA Hopper (H100).

The layout mirrors ``repro``: ``analysis``, ``configs``, ``core``, ``data``,
``models``, ``kernels``, ``optim``, ``parallel``, ``scheduler``,
``serving``, ``training``, ``launch`` and ``utils`` sit where their JAX
counterparts do.
The port imports ``torch`` and never ``jax``, and nothing of ``repro``: it
keeps its own copies of the JAX-free pieces it needs.

Sub-packages load lazily (PEP 562), so ``import repro_torch`` is cheap and
pulls in no kernel build.
"""
import importlib

_SUBMODULES = ("analysis", "bridge", "configs", "core", "data", "kernels",
               "launch", "models", "optim", "parallel", "scheduler",
               "serving", "training", "utils")


def __getattr__(name):
    if name in _SUBMODULES:
        mod = importlib.import_module(f"repro_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
