"""The cross-entropy backward's share of its roofline, in %: the least
time of the backward's work at each call's shapes, summed over the calls,
over the device time the profiler gives the autograd node of the loss
(``_FusedCrossEntropyBackward``, ``kernels/fused_ce/ops.py``) with
everything it runs.  The least work is three products of the forward's
(``costs.cross_entropy_stats`` over a slice's tokens and the whole
vocabulary, bf16 operands): the logits again, dh and dW; and twice its
bytes: hidden and head read, dh and dW written.  It counts the same work
whatever implements the node."""
from bench import costs

NODE = "_FusedCrossEntropyBackward"


def read(run):
    op = run.trace.ops.get(NODE) if run.trace else None
    if op is None or op.device_s <= 0:
        return None
    m, t = run.cell.config["model"], run.cell.traffic
    stats = costs.cross_entropy_stats(run.cell.rows_per_slice * t["seq_len"],
                                      m["d_model"], m["vocab_size"])
    call = costs.Work(3 * stats.flops, 2 * stats.bytes)
    return 100.0 * op.count * call.bound_s() / op.device_s
