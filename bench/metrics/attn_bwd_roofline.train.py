"""The attention backward's share of its roofline, in %: the least time
of the backward's work at each call's shapes (``costs.attention_bwd``:
causal, bf16 operands, kv heads repeated to the query heads as the call
takes them), summed over the calls, over the device time the profiler
gives the autograd node of the attention (``_SwaAttentionBackward``,
``kernels/swa_attention/ops.py``) with everything it runs."""
from bench import costs

NODE = "_SwaAttentionBackward"


def read(run):
    op = run.trace.ops.get(NODE) if run.trace else None
    if op is None or op.device_s <= 0:
        return None
    m, t = run.cell.config["model"], run.cell.traffic
    hd = m.get("head_dim") or m["d_model"] // m["num_heads"]
    call = costs.attention_bwd(run.cell.rows_per_slice, t["seq_len"],
                               m["num_heads"], hd)
    return 100.0 * op.count * call.bound_s() / op.device_s
