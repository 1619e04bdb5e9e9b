"""Device milliseconds a step of idle at the runtime's boundary: the gaps
between the device's operations that fall inside the host interval of the
program's ``elastic.step`` span (``core/elastic.py::ElasticRuntime.
run_steps``, one a step) and outside its ``step.forward``,
``step.backward`` and ``step.update`` spans, summed over the traced steps,
over the steps.  That is the batch and its copies, the step function's own
code before its first launch and between the slices and the update, the
drain at the barrier's first read, and the loss read."""
from bench.metrics._idle import idle_within

RUNTIME = ("elastic.step",)
STEP = ("step.forward", "step.backward", "step.update")


def read(run):
    if not run.trace:
        return None
    idle = idle_within(run.trace, RUNTIME, STEP)
    return None if idle is None else 1e3 * idle / run.trace.steps
