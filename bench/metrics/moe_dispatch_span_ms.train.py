"""Device milliseconds a step of the MoE's dispatch and combine: the
kernels the profiler gives the program's ``moe.dispatch`` span (the slots,
the kept entries and their scatter into the expert buffers) and its
``moe.combine`` span (the gather back and the weighted sum), both in
``models/moe.py::_local_expert_ffn``, in the forward and in its recompute
under remat, summed over the traced steps, over the steps.  Their
backward passes run outside the spans and are not counted.  Whatever
operators implement the dispatch, the spans hold them."""
SPANS = ("moe.dispatch", "moe.combine")


def read(run):
    if not run.trace:
        return None
    ops = [run.trace.ops.get(name) for name in SPANS]
    if any(op is None for op in ops):
        return None
    total = sum(op.device_s for op in ops)
    if total <= 0:
        return None
    return 1e3 * total / run.trace.steps
