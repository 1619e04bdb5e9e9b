"""The share of the measured window in which no operation ran on the
device, in %: 1 - (the device's busy time a step, the union of its
operations' intervals in the traced sub-window over its steps) / (the
measured window's host time a step).  The window runs untraced, so the
profiler's own host overhead, which stretches the traced sub-window
between launches, is not counted as idle."""


def read(run):
    if not run.trace or run.trace.busy_s <= 0 or not run.step_s:
        return None
    busy = run.trace.busy_s / run.trace.steps
    return 100.0 * (1.0 - busy / (run.window_s / len(run.step_s)))
