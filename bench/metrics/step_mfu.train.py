"""The step's model FLOPs over its device time, as a share of the H100's
dense bf16 peak, in %.  The FLOPs are the configuration's family module's
``step_flops(model, tokens_per_row, rows)`` where it defines one, and
otherwise ``costs.step_flops`` (6 N T and the causal attention products
of a dense or MoE transformer, no recomputation).  The step time is the
mean of the measured window's steps, each timed by CUDA events around the
runtime's call, outside the traced sub-window."""
from bench import costs, reference


def read(run):
    if not run.step_s:
        return None
    t = run.cell.traffic
    step_flops = getattr(reference.load(run.cell.config), "step_flops",
                         costs.step_flops)
    flops = step_flops(run.cell.config["model"], t["seq_len"],
                       t["global_batch"])
    step_s = sum(run.step_s) / len(run.step_s)
    return 100.0 * flops / step_s / costs.PEAK_BF16_FLOPS
