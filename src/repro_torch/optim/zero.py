"""ZeRO partial sharding, the placement rules (port of part of
``repro.optim.zero``, paper §5.4).

A job whose optimizer state is sharded ``shard_factor``-way over a DP
degree of k x shard_factor can be time-sliced at most k-way: only replicas
of the same ZeRO shard are spliced together.  The partition specs of the
JAX module belong to the multi-GPU slice (ROADMAP M9).
"""
from __future__ import annotations

from typing import List


def shard_group(rank: int, dp_degree: int, shard_factor: int) -> int:
    """Which ZeRO shard a DP rank holds: ranks {i, i + shard_factor, ...}
    hold the same shard, the groups that may be spliced together."""
    max_splice_factor(dp_degree, shard_factor)
    return rank % shard_factor


def spliceable_groups(dp_degree: int, shard_factor: int) -> List[List[int]]:
    """Groups of DP ranks holding identical optimizer shards (spliceable)."""
    return [[r for r in range(dp_degree)
             if shard_group(r, dp_degree, shard_factor) == g]
            for g in range(shard_factor)]


def max_splice_factor(dp_degree: int, shard_factor: int) -> int:
    """Paper: DP = k x shard_factor supports up to k-way time-slicing."""
    if shard_factor <= 0 or dp_degree % shard_factor:
        raise ValueError(f"DP degree {dp_degree} is not a multiple of the "
                         f"ZeRO shard factor {shard_factor}")
    return dp_degree // shard_factor


def validate_partial_sharding(dp_degree: int, shard_factor: int,
                              target_splice: int) -> None:
    """Refuse a resize that would splice ranks of different ZeRO shards."""
    k = max_splice_factor(dp_degree, shard_factor)
    if target_splice > k:
        raise ValueError(
            f"cannot splice {target_splice}-way: ZeRO shard factor "
            f"{shard_factor} with DP={dp_degree} supports at most {k}-way "
            f"time-slicing (paper §5.4 partial sharding)")
