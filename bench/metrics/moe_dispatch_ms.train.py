"""Device milliseconds a step of the MoE's dispatch and combine: the
kernels the profiler gives, as their own, to the index operators of
``models/moe.py`` (the scatter into the expert buffers and its backward,
the gather back and its backward, the running count of each expert's
slots and its lookup), summed over the traced steps, over the steps.
None of these operators runs outside the expert layer in a training step
of the dense and MoE transformers."""
OPS = ("aten::index_add_", "aten::index_select", "aten::cumsum",
       "aten::gather")


def read(run):
    if not run.trace:
        return None
    times = [run.trace.ops.get(name) for name in OPS]
    total = sum(op.self_device_s for op in times if op is not None)
    if total <= 0:
        return None
    return 1e3 * total / run.trace.steps
