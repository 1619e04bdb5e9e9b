"""Device milliseconds a step of the gradient sum: the kernels the
profiler gives the program's ``step.grad_sum`` span (each layer's
gradient added into its stacked leaf's sum, ``models/model.py::
_GradSum.add``, and the sums divided by the splice, ``training/step.py::
loss_and_grads``), plus those of autograd's own accumulation into
``.grad`` of the leaves that are not stacked
(``torch::autograd::AccumulateGrad``), summed over the traced steps, over
the steps."""
SPAN = "step.grad_sum"
ACCUMULATE = "torch::autograd::AccumulateGrad"


def read(run):
    op = run.trace.ops.get(SPAN) if run.trace else None
    if op is None:
        return None
    acc = run.trace.ops.get(ACCUMULATE)
    total = op.device_s + (acc.device_s if acc is not None else 0.0)
    if total <= 0:
        return None
    return 1e3 * total / run.trace.steps
