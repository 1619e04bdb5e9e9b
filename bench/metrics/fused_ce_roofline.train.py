"""The ``fused_ce_stats`` kernel's share of its roofline, in %: the least
time of each call's work (``costs.cross_entropy_stats`` over a slice's
tokens and the whole vocabulary, bf16 operands), summed over the calls,
over the device time the profiler gives the ``repro_torch::fused_ce_stats``
op."""
from bench import costs

OP = "repro_torch::fused_ce_stats"


def read(run):
    op = run.trace.ops.get(OP) if run.trace else None
    if op is None or op.device_s <= 0:
        return None
    m, t = run.cell.config["model"], run.cell.traffic
    call = costs.cross_entropy_stats(run.cell.rows_per_slice * t["seq_len"],
                                     m["d_model"], m["vocab_size"])
    return 100.0 * op.count * call.bound_s() / op.device_s
