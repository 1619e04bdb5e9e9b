"""Spans at the layer boundaries of the elastic training step.

``span(name)`` is a context manager that the profiler records as a host
operator (``cpu_op``, the event type of an aten op) while a
``torch.profiler`` is active, and that costs one enter and one exit
otherwise.  Active tracing is the profiler; there is no other switch.  A
span is not ``record_function``: that records a ``user_annotation``, which
the profiler mirrors on the device as an interval from the span's first
kernel to its last, so it would be counted as device work and fill the
idle gaps it is meant to explain.  A span's device time, in
``key_averages()``, is that of the kernels launched inside it on its own
thread.

The spans, where each opens, and the benchmark's metric that reads it
(``bench/metrics/<metric>.py``):

- ``elastic.step``: ``core/elastic.py::ElasticRuntime.run_steps``, one
  step of the runtime: the batch and its copies to the device, the step
  function's call, ``barrier.observe`` (the step's first read of the
  device) and the record's step, loss and gradient norm read to the host;
  ``boundary_idle_ms.train``.
- ``step.forward``: ``training/step.py::loss_and_grads``, one slice's
  forward; ``slice_idle_ms.train``.
- ``step.backward``: the same, one slice's backward;
  ``slice_idle_ms.train``.
- ``step.grad_sum``: ``models/model.py::_GradSum.add``, one layer's
  gradient added into a stacked leaf's sum (on autograd's thread), and
  ``loss_and_grads``'s hand-over of the sums, divided by the splice;
  ``grad_sum_ms.train``.
- ``step.update``: ``training/step.py::train_step``, the learning rate,
  the AdamW update (with the global norm) and the step counter; excluded
  by ``boundary_idle_ms.train``.  No metric reads its device time: where
  the host waits on a full launch queue inside it, the profiler nests
  ``Command Buffer Full`` records in it, and ``key_averages()`` gives each
  of them the kernels of an unrelated operator whose id equals the
  record's.
- ``moe.dispatch``: ``models/moe.py::_local_expert_ffn``, the slots, the
  kept entries and their scatter into the expert buffers;
  ``moe_dispatch_span_ms.train``.
- ``moe.combine``: the same, the gather back and the weighted sum;
  ``moe_dispatch_span_ms.train``.
- ``ssm.mixer``: ``models/ssm.py::ssm_prefill``, one Mamba2 mixer from
  its in_proj to its out_proj (the conv, the SSD, the D skip and the gated
  norm between), in the forward and in its recompute under remat;
  ``ssm_mixer_ms.train``.
- ``ssm.scan``: inside ``ssm.mixer``, the SSD of ``kernels/ssd_scan/
  ops.py::ssd_chunked``: the intra-chunk kernel, the recurrence across the
  chunks and the inter-chunk output; ``ssm_scan_ms.train``.  Its backward
  runs outside the span, under the autograd node
  ``_SsdIntraChunkBackward`` and the nodes of the plain recurrence.
"""
from __future__ import annotations

import torch

NAMES = ("elastic.step", "step.forward", "step.backward", "step.grad_sum", "step.update",
         "moe.dispatch", "moe.combine", "ssm.mixer", "ssm.scan")


def span(name: str):
    """A context manager that records ``name`` as a host operator while a
    profiler is active."""
    return torch._C._profiler._RecordFunctionFast(name)
