"""Device milliseconds a step of the Mamba2 mixers: the kernels the
profiler gives the program's ``ssm.mixer`` span (``models/ssm.py::
ssm_prefill``, one Mamba2 mixer from its in_proj to its out_proj), in the
forward and in its recompute under remat, summed over the traced steps,
over the steps.  Their backward passes run outside the span and are not
counted."""
SPAN = "ssm.mixer"


def read(run):
    op = run.trace.ops.get(SPAN) if run.trace else None
    if op is None or op.device_s <= 0:
        return None
    return 1e3 * op.device_s / run.trace.steps
