"""Parameter trees: nested dicts of tensors with ``None`` for absent leaves
(olmo's norms), the port's stand-in for JAX pytrees."""
from __future__ import annotations

from typing import Any, Callable, List


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn(leaf, *leaves)`` over ``tree`` and trees of its structure,
    matched by key; ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List:
    """The leaves in key order, ``None`` left out."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree: Any, leaves: List) -> Any:
    """A tree of ``tree``'s structure with ``leaves`` in key order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)
