"""The five kernels as ``torch.library`` ops, and each op's cost formula.

Each kernel is one op in the ``repro_torch`` namespace
(``torch.ops.repro_torch.swa_flash``, ``.swa_flash_bwd``,
``.ssd_intra_chunk``, ``.fused_ce_stats``, ``.fingerprint_u32``), defined
beside its wrapper in its ``ops.py`` by ``kernel_op``, with three
implementations:

- CUDA tensors: the hand-written kernel's ctypes wrapper, which launches
  (and counts the launch) or raises;
- CPU tensors: the plain PyTorch version of ``ref.py``;
- fake tensors (``FakeTensorMode``, and ``meta``): a fake implementation
  that returns the kernel's output shapes, dtypes and strides and computes
  nothing.  The planner (``launch/dryrun.py``) traces the models on fake
  tensors, so it traces the kernel path the card runs.

No other device has an implementation: the op raises there.  No DTensor
strategy is registered: every caller runs the op on its local shards
inside ``parallel/constraints.shard_map``.  The ops carry no autograd
formula; the autograd functions of the ``ops.py`` modules call them
(``swa_attention``'s calls ``swa_flash`` in its forward and
``swa_flash_bwd`` in its bf16 backward; ``fused_ce``'s keeps a plain
backward).

``COSTS`` maps each op's name to its formula: the work of one call from
its arguments' shapes.  ``analysis/op_cost.py`` counts it in place of its
matmul and operand rules, and ``chip_smoke.py`` divides it by the card's
data-sheet rates for each kernel's bound.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

NAMESPACE = "repro_torch"


class KernelCost(NamedTuple):
    """The work one call must do: ``flops`` floating-point operations,
    ``int_ops`` 32-bit integer instructions, and ``bytes`` moved with each
    input read once and each output written once."""
    flops: int
    bytes: int
    int_ops: int = 0


COSTS: Dict[str, Callable[..., KernelCost]] = {}


def kernel_op(name: str, schema: str, *, cpu: Callable, cuda: Callable,
              fake: Callable, cost: Callable[..., KernelCost]):
    """Define ``repro_torch::<name>`` with ``schema`` (no argument is
    mutated), its CPU, CUDA and fake implementations, and its cost formula
    (a function of the op's arguments).  Returns the op.  Each ``cuda``
    implementation calls its wrapper by the ``ops.py`` module's name for
    it, so that a comparison can swap the wrapper for the plain version
    (``chip_smoke.py::plain_versions``)."""
    op = torch.library.custom_op(f"{NAMESPACE}::{name}", cpu,
                                 mutates_args=(), device_types="cpu",
                                 schema=schema)
    op.register_kernel("cuda")(cuda)
    op.register_fake(fake)
    COSTS[name] = cost
    return op
