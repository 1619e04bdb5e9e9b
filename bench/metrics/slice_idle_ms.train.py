"""Device milliseconds a step of idle inside the slices: the gaps between
the device's operations that fall inside the host intervals of the
program's ``step.forward`` and ``step.backward`` spans
(``training/step.py::loss_and_grads``, one of each a slice), summed over
the traced steps, over the steps.  That is the launch-bound part of the
slices, which the splicing layer's thinner slices make larger."""
from bench.metrics._idle import idle_within

SLICES = ("step.forward", "step.backward")


def read(run):
    if not run.trace:
        return None
    idle = idle_within(run.trace, SLICES)
    return None if idle is None else 1e3 * idle / run.trace.steps
