"""Device milliseconds a step of the SSD inside the Mamba2 mixers: the
kernels the profiler gives the program's ``ssm.scan`` span (around
``kernels/ssd_scan/ops.py::ssd_chunked``: the intra-chunk kernel, the
recurrence across the chunks and the inter-chunk output), in the forward
and in its recompute under remat, summed over the traced steps, over the
steps."""
SPAN = "ssm.scan"


def read(run):
    op = run.trace.ops.get(SPAN) if run.trace else None
    if op is None or op.device_s <= 0:
        return None
    return 1e3 * op.device_s / run.trace.steps
