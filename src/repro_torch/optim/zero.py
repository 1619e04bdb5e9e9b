"""ZeRO partial sharding, the placement rules (port of part of
``repro.optim.zero``, paper §5.4).

A job whose optimizer state is sharded ``shard_factor``-way over a DP
degree of k x shard_factor can be time-sliced at most k-way: only replicas
of the same ZeRO shard are spliced together.  Here are (a) the placement
rule the elastic runtime enforces and (b) the specs the launcher builds,
tuples of mesh-axis names per tensor dim (``parallel/sharding.py``), with
the host-side slice of one shard.
"""
from __future__ import annotations

from typing import Any, List, Tuple

from repro_torch.parallel.sharding import tree_map_with_path


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


def partial_shard_specs(params: Any, shard_factor: int,
                        data_axis: str = "data") -> Any:
    """Specs sharding optimizer state over a sub-slice of the data axis.
    shard_factor=1 -> fully replicated optimizer state (pure DP);
    shard_factor=dp -> fully sharded (classic ZeRO-1).

    Each tensor's largest axis divisible by the factor (the last of equal
    ones) goes over the data axis."""
    def spec_for(_path, leaf) -> Tuple:
        if shard_factor == 1 or not hasattr(leaf, "shape") \
                or len(leaf.shape) == 0:
            return ()
        shape = tuple(leaf.shape)
        cands = [(dim, ax) for ax, dim in enumerate(shape)
                 if dim % shard_factor == 0]
        if not cands:
            return ()
        _, ax = max(cands)
        spec = [None] * len(shape)
        spec[ax] = data_axis
        return tuple(spec)

    return tree_map_with_path(spec_for, params)


def shard_slice(leaf, spec: Tuple, shard_idx: int, shard_factor: int):
    """Host-side slice of a leaf for a given ZeRO shard (checkpoint
    layout): the first sharded axis of ``spec`` cut into ``shard_factor``
    equal parts."""
    for ax, name in enumerate(spec):
        if name is not None:
            n = leaf.shape[ax] // shard_factor
            sl = [slice(None)] * leaf.ndim
            sl[ax] = slice(shard_idx * n, (shard_idx + 1) * n)
            return leaf[tuple(sl)]
    return leaf
