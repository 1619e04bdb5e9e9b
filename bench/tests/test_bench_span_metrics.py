"""The readers of the program's spans (``grad_sum_ms.train``,
``slice_idle_ms.train``, ``boundary_idle_ms.train``,
``moe_dispatch_span_ms.train``) against traces built by hand: nested
spans, gaps that straddle a span's edge, spans of two threads that overlap
in time, one traced step, and a span missing."""
from __future__ import annotations

import pytest

from _smoke import ROOT  # noqa: F401  (puts the checkout on sys.path)
from bench import harness, trace as trace_lib
from bench.metrics._idle import idle_within

SPAN_READERS = ("grad_sum_ms.train", "slice_idle_ms.train",
                "boundary_idle_ms.train", "moe_dispatch_span_ms.train")
ALL_SPANS = ("elastic.step", "step.forward", "step.backward",
             "step.grad_sum", "step.update", "moe.dispatch", "moe.combine")

# One step, in seconds.  The runtime's span holds the step 0-10: the batch
# 0-1, the step function 1-9 (forward 1.5-4, backward 4-7, the update
# 7.5-8.5, a gradient add on autograd's thread 5-5.5 inside the
# backward), the barrier's read 9-9.5 and the loss read 9.5-10.  The device's gaps, and
# where each falls (slice, boundary, update, outside every span):
#   1.2-1.3  in the step before the forward: boundary 0.1
#   2.0-2.5  in the forward: slice 0.5
#   3.8-4.4  across the forward's end and the backward's start: slice 0.6
#   6.8-7.7  across the backward's end and the update's start: slice 0.2,
#            boundary 0.5, update 0.2
#   8.4-9.2  across the update's end and the step's: update 0.1,
#            boundary 0.7
#   9.3-10.5 across the loss read's end: boundary 0.7, outside 0.5
HOST = [("elastic.step", 0.0, 10.0), ("aten::copy_", 0.4, 0.6),
        ("step.forward", 1.5, 4.0),
        ("aten::mm", 2.0, 3.0), ("step.backward", 4.0, 7.0),
        ("step.grad_sum", 5.0, 5.5), ("step.update", 7.5, 8.5)]
DEVICE = [("Memcpy HtoD", 0.5, 1.2), ("gemm", 1.3, 2.0), ("gemm", 2.5, 3.8),
          ("gemm", 4.4, 6.8), ("adam", 7.7, 8.4), ("item", 9.2, 9.3),
          ("next", 10.5, 11.0)]
OPS = {"step.update": trace_lib.OpTime(1, 0.7, 0.0),
       "step.grad_sum": trace_lib.OpTime(40, 0.3, 0.0),
       "torch::autograd::AccumulateGrad": trace_lib.OpTime(3, 0.05, 0.0),
       "moe.dispatch": trace_lib.OpTime(4, 0.2, 0.0),
       "moe.combine": trace_lib.OpTime(4, 0.1, 0.0),
       "aten::index_add_": trace_lib.OpTime(4, 0.15, 0.15)}
SLICE, BOUNDARY, UPDATE, OUTSIDE = 1.3, 2.0, 0.3, 0.5


def _read(name, tr, cell="olmo1b-train-s4"):
    run = harness.Run(harness.load_cell(cell), [1.0], tr, 1.0)
    return harness.metric_reader(name)(run)


def _trace(steps=1, host=HOST, ops=OPS):
    return trace_lib.Trace(steps, 11.0, list(DEVICE), list(host), dict(ops))


def test_nested_spans_and_gaps_across_their_edges():
    tr = _trace()
    assert _read("slice_idle_ms.train", tr) == pytest.approx(1e3 * SLICE)
    assert _read("boundary_idle_ms.train", tr) == pytest.approx(
        1e3 * BOUNDARY)


def test_the_four_parts_of_the_idle_sum_to_the_traced_idle():
    """Slices, boundary, the update and outside every span: each gap's
    time falls in exactly one."""
    tr = _trace()
    total = sum(length for _, length in trace_lib.gaps(
        [(a, b) for _, a, b in tr.device]))
    update = idle_within(tr, ("step.update",),
                         ("step.forward", "step.backward"))
    inside = idle_within(tr, [n for n in ALL_SPANS
                              if not n.startswith("moe.")])
    assert update == pytest.approx(UPDATE)
    assert total - inside == pytest.approx(OUTSIDE)
    parts = (_read("slice_idle_ms.train", tr)
             + _read("boundary_idle_ms.train", tr)) / 1e3 + update \
        + (total - inside)
    assert parts == pytest.approx(total)


def test_spans_of_two_threads_that_overlap_count_once():
    """A forward of another thread inside the main one's counts its gap
    once; an update of another thread during the barrier's read takes
    its time out of the boundary."""
    host = HOST + [("step.forward", 2.2, 3.0), ("step.update", 9.4, 9.8)]
    tr = _trace(host=host)
    assert _read("slice_idle_ms.train", tr) == pytest.approx(1e3 * SLICE)
    assert _read("boundary_idle_ms.train", tr) == pytest.approx(
        1e3 * (BOUNDARY - 0.4))


def test_device_time_of_the_spans_over_the_steps():
    tr = _trace(steps=2)
    assert _read("grad_sum_ms.train", tr) == pytest.approx(
        1e3 * 0.35 / 2)
    assert _read("moe_dispatch_span_ms.train", tr,
                 "granite-moe-train-s1") == pytest.approx(1e3 * 0.3 / 2)
    assert _read("slice_idle_ms.train", tr) == pytest.approx(
        1e3 * SLICE / 2)
    # the leaves that are not stacked may take no accumulation
    ops = {k: v for k, v in OPS.items()
           if k != "torch::autograd::AccumulateGrad"}
    assert _read("grad_sum_ms.train", _trace(ops=ops)) == pytest.approx(
        1e3 * 0.3)


@pytest.mark.parametrize("missing,silent", [
    ("step.update", {"boundary_idle_ms.train"}),
    ("step.grad_sum", {"grad_sum_ms.train"}),
    ("step.forward", {"slice_idle_ms.train", "boundary_idle_ms.train"}),
    ("elastic.step", {"boundary_idle_ms.train"}),
    ("moe.combine", {"moe_dispatch_span_ms.train"}),
])
def test_one_traced_step_with_a_span_missing(missing, silent):
    """A reader reads None where a span it reads is missing, and the
    others read on."""
    tr = _trace(host=[h for h in HOST if h[0] != missing],
                ops={k: v for k, v in OPS.items() if k != missing})
    for name in SPAN_READERS:
        value = _read(name, tr, "granite-moe-train-s1")
        assert (value is None) == (name in silent), name


def test_a_program_without_spans_reads_nothing():
    """The parent's trace, with its operators and no span, gives no
    reading, and raises nothing."""
    host = [h for h in HOST if not h[0].startswith(("elastic.", "step."))]
    ops = {"aten::index_add_": OPS["aten::index_add_"],
           "torch::autograd::AccumulateGrad": trace_lib.OpTime(3, 0.0, 0.0)}
    tr = _trace(host=host, ops=ops)
    for name in SPAN_READERS:
        assert _read(name, tr, "granite-moe-train-s1") is None
        assert _read(name, None, "granite-moe-train-s1") is None
