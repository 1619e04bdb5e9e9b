"""The yardstick's arithmetic: the card's published peaks and the work of
a training step and of each kernel's call, from shapes alone.

These formulas are the benchmark's own frozen copies.  The program keeps
its own (``swa_flash_cost`` and ``fused_ce_stats_cost`` beside its ops);
a change there moves nothing here, so a roofline share can only move with
the time the program takes.
"""
from __future__ import annotations

from typing import NamedTuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W power limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16_BYTES = 2


class Work(NamedTuple):
    flops: float
    bytes: float

    def bound_s(self) -> float:
        """The least time the card could take: the larger of the
        operations over the bf16 peak and the bytes over the HBM peak."""
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_HBM_BYTES)


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask keeps over ``s`` positions."""
    return s * (s + 1) // 2


def attention_fwd(b: int, s: int, h: int, d: int,
                  elsize: int = BF16_BYTES) -> Work:
    """One causal attention forward over (b, s, h, d) q, k, v: the score
    and value products (2 flops a multiply-add) over the kept pairs; q, k,
    v read once and o written once."""
    return Work(4 * d * causal_pairs(s) * b * h, 4 * b * s * h * d * elsize)


def attention_bwd(b: int, s: int, h: int, d: int,
                  elsize: int = BF16_BYTES) -> Work:
    """Its backward's least work: the four products dV = P^T dO,
    dP = dO V^T, dQ = dS K and dK = dS^T Q over the kept pairs (P taken as
    given: recomputing it is not counted); q, k, v and dO read once, dq,
    dk and dv written once."""
    return Work(8 * d * causal_pairs(s) * b * h, 7 * b * s * h * d * elsize)


def cross_entropy_stats(t: int, d: int, v: int,
                        elsize: int = BF16_BYTES) -> Work:
    """The (lse, label logit) of ``t`` rows: the logits' product, 2 t d v
    flops; hidden and head read once, int32 labels read and two f32
    outputs written."""
    return Work(2 * t * d * v, elsize * (t * d + d * v) + 4 * t + 8 * t)


def matmul_params(model: dict) -> int:
    """Parameters a token multiplies by in a forward pass of a dense or
    MoE transformer: its attention and feed-forward (MoE: the router and
    its top-k experts) in every layer, and the output head.  The input
    embedding is a lookup and not counted; a tied head counts the table
    once, as the head."""
    d, v, ff = model["d_model"], model["vocab_size"], model["d_ff"]
    h, kvh = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // h
    attn = d * h * hd * 2 + d * kvh * hd * 2
    mult = 3 if model["mlp"] == "swiglu" else 2
    moe = model.get("moe")
    if moe:
        ffn = d * moe["num_experts"] + mult * d * ff * moe["top_k"]
    else:
        ffn = mult * d * ff
    return model["num_layers"] * (attn + ffn) + d * v


def step_flops(model: dict, tokens_per_row: int, rows: int) -> float:
    """Model FLOPs of one training step over ``rows`` sequences of
    ``tokens_per_row``: 6 N T for the products with weights (forward 2,
    backward 4) and three times the causal attention forward for the
    score and value products.  Recomputation is not counted."""
    t = tokens_per_row * rows
    h = model["num_heads"]
    hd = model.get("head_dim") or model["d_model"] // h
    attn = 3 * attention_fwd(rows, tokens_per_row, h, hd).flops
    return 6 * matmul_params(model) * t + model["num_layers"] * attn
