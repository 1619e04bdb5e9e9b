"""The ``ssd_intra_chunk`` kernel's share of its roofline, in %: the least
time of each call's work (``costs_ssd.ssd_intra_chunk_cost`` at the
call's shapes: a slice's rows padded to chunks of the configuration's
``chunk_size``, bf16 x, B and C), summed over the calls, over the device
time the profiler gives the ``repro_torch::ssd_intra_chunk`` op."""
from bench import costs_ssd

OP = "repro_torch::ssd_intra_chunk"


def read(run):
    op = run.trace.ops.get(OP) if run.trace else None
    if op is None or op.device_s <= 0:
        return None
    call = costs_ssd.ssd_call(run.cell.config["model"],
                              run.cell.rows_per_slice,
                              run.cell.traffic["seq_len"])
    bound = costs_ssd.ssd_intra_chunk_cost(*call).bound_s()
    return 100.0 * op.count * bound / op.device_s
