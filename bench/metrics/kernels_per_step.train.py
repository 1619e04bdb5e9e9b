"""Device kernels launched a step in the traced sub-window (copies and
fills left out): the host's dispatch load."""


def read(run):
    if not run.trace or run.trace.kernels == 0:
        return None
    return run.trace.kernels / run.trace.steps
