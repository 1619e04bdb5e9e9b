"""The work of the SSD's intra-chunk step, forward and backward, from
shapes alone: the benchmark's own frozen copy, as ``costs.py`` keeps its
copies of the attention's and the CE's formulas.  A change of the
program's formula (``kernels/ssd_scan/ops.py::ssd_intra_chunk_cost``)
moves nothing here.

A call takes BC chunks of Q positions, H heads of P channels and a state
of N, with x, B and C in ``elsize`` bytes an element and dt (BC, Q, H)
and A (H) in f32; it returns y (BC, Q, H, P), the chunks' states (BC, H,
P, N) and the running sums of dt A (BC, Q, H), all f32.  With
pairs = Q (Q + 1) / 2, the causal pairs of a chunk:

- forward operations, 2 flops a multiply-add: C B^T once a chunk over its
  pairs, 2 BC N pairs; M x over the pairs for every head, 2 BC H P pairs;
  the states x^T (w B) in full for every head, 2 BC H Q P N;
- forward bytes: its inputs read once, elsize BC Q (H P + 2 N) + 4 (BC Q
  H + H), and its outputs written once, 4 (BC Q H P + BC H P N + BC Q H);
- backward operations, its least work: each forward product's two
  gradient products, twice the forward's operations;
- backward bytes: the forward's inputs and the gradients of its outputs
  read once, and the gradients of its inputs (each the size of its input)
  written once: 2 x (the forward's input bytes) + (its output bytes).
"""
from __future__ import annotations

from bench.costs import BF16_BYTES, Work


def _parts(bc: int, q: int, h: int, p: int, n: int, elsize: int):
    pairs = q * (q + 1) // 2
    flops = 2 * bc * (n * pairs + h * p * pairs + h * q * p * n)
    inputs = elsize * bc * q * (h * p + 2 * n) + 4 * (bc * q * h + h)
    outputs = 4 * (bc * q * h * p + bc * h * p * n + bc * q * h)
    return flops, inputs, outputs


def ssd_intra_chunk_cost(bc: int, q: int, h: int, p: int, n: int,
                         elsize: int = BF16_BYTES) -> Work:
    """One forward call's least work."""
    flops, inputs, outputs = _parts(bc, q, h, p, n, elsize)
    return Work(flops, inputs + outputs)


def ssd_intra_chunk_bwd(bc: int, q: int, h: int, p: int, n: int,
                        elsize: int = BF16_BYTES) -> Work:
    """One backward call's least work."""
    flops, inputs, outputs = _parts(bc, q, h, p, n, elsize)
    return Work(2 * flops, 2 * inputs + outputs)


def ssd_call(model: dict, rows: int, seq_len: int):
    """(BC, Q, H, P, N) of each intra-chunk call of a slice of ``rows``
    sequences of ``seq_len``: the sequence padded to whole chunks of the
    configuration's ``chunk_size``."""
    s = model["ssm"]
    q = s["chunk_size"]
    heads = s["expand"] * model["d_model"] // s["head_dim"]
    return (rows * -(-seq_len // q), q, heads, s["head_dim"], s["state_dim"])
