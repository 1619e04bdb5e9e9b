"""The ``swa_flash`` kernel's share of its roofline, in %: the least time
of each call's work (``costs.attention_fwd``: causal, bf16, each input
read once and the output written once), summed over the calls, over the
device time the profiler gives the ``repro_torch::swa_flash`` op."""
from bench import costs

OP = "repro_torch::swa_flash"


def read(run):
    op = run.trace.ops.get(OP) if run.trace else None
    if op is None or op.device_s <= 0:
        return None
    m, t = run.cell.config["model"], run.cell.traffic
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    call = costs.attention_fwd(run.cell.rows_per_slice, t["seq_len"],
                               m["num_heads"], hd)
    return 100.0 * op.count * call.bound_s() / op.device_s
