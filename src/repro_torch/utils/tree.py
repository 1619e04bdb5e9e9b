"""Parameter trees: nested dicts of tensors with ``None`` for absent leaves
(olmo's norms), the port's stand-in for JAX pytrees.

``tree_leaves``/``tree_unflatten`` walk a tree in its own key order.
``tree_flatten``/``tree_unflatten_sorted`` walk it in the order of
``jax.tree_util.tree_flatten``: at every level the dict keys sorted, and
``None`` leaves dropped (JAX treats ``None`` as a node with no children).
A checkpoint manifest lists its leaves in that order, so that the JAX
package and the port address the same chunks for the same state.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

Path = Tuple[str, ...]


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


def tree_flatten(tree: Any) -> Tuple[List, List[Path]]:
    """(leaves, key paths) in ``jax.tree_util.tree_flatten``'s order: each
    dict's keys sorted, ``None`` leaves dropped."""
    leaves, paths = [], []

    def walk(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k], path + (k,))
        elif t is not None:
            leaves.append(t)
            paths.append(path)

    walk(tree, ())
    return leaves, paths


def tree_unflatten_sorted(tree: Any, leaves: List) -> Any:
    """The inverse of ``tree_flatten``: a tree of ``tree``'s structure (its
    own key order, its ``None`` leaves) whose leaves are ``leaves``, given
    in ``tree_flatten``'s order."""
    _, paths = tree_flatten(tree)
    if len(paths) != len(leaves):
        raise ValueError(f"the tree has {len(paths)} leaves; got "
                         f"{len(leaves)}")
    by_path = dict(zip(paths, leaves))

    def build(t, path):
        if isinstance(t, dict):
            return {k: build(v, path + (k,)) for k, v in t.items()}
        return None if t is None else by_path[path]

    return build(tree, ())


def tree_spec(tree: Any) -> Dict[str, List]:
    """The structure of a tree of str-keyed dicts, as JSON: ``paths``, the
    key path of every leaf in the tree's own order, and ``none``, the
    indices of the ``None`` leaves among them."""
    paths, none = [], []

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                if not isinstance(k, str):
                    raise TypeError(f"a tree key must be a str; got {k!r}")
                walk(v, path + [k])
        else:
            if t is None:
                none.append(len(paths))
            paths.append(path)

    walk(tree, [])
    return {"paths": paths, "none": none}


def tree_from_spec(spec: Dict[str, List]) -> Any:
    """A tree of ``tree_spec``'s structure, each leaf ``True`` and the
    ``None`` leaves ``None``: a template for ``tree_unflatten_sorted``."""
    none = set(spec["none"])
    if spec["paths"] == [[]]:
        return None if none else True
    root: Dict = {}
    for i, path in enumerate(spec["paths"]):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = None if i in none else True
    return root
