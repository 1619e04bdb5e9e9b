"""The SSD intra-chunk backward's share of its roofline, in %: the least
time of the backward's work at each call's shapes
(``costs_ssd.ssd_intra_chunk_bwd``), summed over the calls, over the
device time the profiler gives the autograd node of the intra-chunk step
(``_SsdIntraChunkBackward``, ``kernels/ssd_scan/ops.py``) with everything
it runs."""
from bench import costs_ssd

NODE = "_SsdIntraChunkBackward"


def read(run):
    op = run.trace.ops.get(NODE) if run.trace else None
    if op is None or op.device_s <= 0:
        return None
    call = costs_ssd.ssd_call(run.cell.config["model"],
                              run.cell.rows_per_slice,
                              run.cell.traffic["seq_len"])
    bound = costs_ssd.ssd_intra_chunk_bwd(*call).bound_s()
    return 100.0 * op.count * bound / op.device_s
