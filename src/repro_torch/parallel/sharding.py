"""Sharding rules for the production meshes (port of
``repro.parallel.sharding``).

Mesh axes: ``("data", "model")`` single-pod (16 x 16) or
``("pod", "data", "model")`` multi-pod (2 x 16 x 16).

Strategy:
- Parameters & optimizer state: FSDP-style — "model" on the natural
  tensor-parallel dim (heads / FFN / experts / vocab) and "data" on the
  largest remaining divisible dim; replicated across "pod" (pods are pure
  DP; gradient all-reduce crosses the pod axis).
- Batch: sharded over ("pod", "data").
- Decode caches: batch dim over ("pod", "data") when divisible; heads/
  head_dim over "model" when divisible.
- Stacked per-layer leading axes are never sharded.

The rules are JAX's, keyed on the same path strings (``['blocks']['attn']
['wq']``: the port's trees have JAX's keys and stacking, ``bridge.py``).
A spec is a tuple with one entry per leading tensor dim (None, an axis
name or a tuple of names), JAX's ``PartitionSpec`` as a tuple; a scalar or
a non-array leaf gets ``()``.  ``to_placements`` turns a tree of specs into
DTensor placements (JAX's ``to_shardings``).  The functions read only the
mesh's axis names and sizes, so a ``launch.mesh.MeshShape`` serves where no
process group exists.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Optional, Tuple

from repro_torch.parallel.constraints import mesh_axis_sizes
from repro_torch.parallel.constraints import to_placements as _placements

# markers for stacked per-layer leading axes (appear ANYWHERE in the path —
# optimizer state nests the param tree under ['m']/['v'])
STACKED_MARKERS = ("['blocks']", "['cross']")


def tree_map_with_path(fn: Callable, tree: Any, path: str = "") -> Any:
    """``fn(path, leaf)`` over a nested dict, ``path`` in
    ``jax.tree_util.keystr``'s form; ``None`` leaves stay ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, f"{path}['{k}']")
                for k, v in tree.items()}
    return fn(path, tree)


def _is_array(leaf) -> bool:
    return hasattr(leaf, "shape") and len(leaf.shape) > 0


def _assign(shape: Tuple[int, ...], start: int, mesh) -> list:
    """Greedy: 'model' on the best divisible dim (preferring trailing dims,
    where the tensor-parallel reduction lives), then 'data' on the largest
    remaining divisible dim."""
    sizes = mesh_axis_sizes(mesh)
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)
    spec: list = [None] * len(shape)

    dims = list(range(start, len(shape)))
    if model > 1:
        order = sorted(dims, key=lambda i: (-int(shape[i] % model == 0), -i))
        for i in order:
            if shape[i] % model == 0 and shape[i] >= model:
                spec[i] = "model"
                break
    if data > 1:
        cands = [i for i in dims if spec[i] is None
                 and shape[i] % data == 0 and shape[i] >= data]
        if cands:
            i = max(cands, key=lambda i: shape[i])
            spec[i] = "data"
    return spec


def _named_param_spec(pstr: str, shape: Tuple[int, ...], start: int,
                      mesh) -> Optional[list]:
    """Megatron-convention tensor-parallel placement by parameter name:
    column-parallel up-projections shard the output dim over "model",
    row-parallel down-projections shard the CONTRACTED dim over "model"
    (matching the activation sharding the model pins via constraints).
    Remaining capacity shards over "data" (FSDP).  Returns None when the
    name has no rule (generic fallback applies)."""
    sizes = mesh_axis_sizes(mesh)
    model, data = sizes.get("model", 1), sizes.get("data", 1)
    dims = shape[start:]
    nd = len(dims)
    spec = [None] * nd

    def fits(i, n):
        return dims[i] % n == 0 and dims[i] >= n

    def put(i, axis, n):
        if spec[i] is None and n > 1 and fits(i, n):
            spec[i] = axis
            return True
        return False

    keys = re.findall(r"\['([^']+)'\]", pstr)
    name = keys[-1] if keys else ""
    in_attn = "'attn'" in pstr
    in_moe = "'moe'" in pstr or "'shared'" in pstr

    matched = True
    if in_attn and name in ("wq", "wk", "wv") and nd == 3:
        put(1, "model", model)          # heads
        put(0, "data", data)            # d_model
    elif in_attn and name == "wo" and nd == 3:
        put(0, "model", model)          # heads (contracted)
        put(2, "data", data)            # d_model
    elif in_moe and name in ("wi", "wg", "wo") and nd == 3:
        # (E, d, f) / (E, f, d): experts over model when divisible,
        # else the FFN dim; data on the remaining big dim
        if not put(0, "model", model):
            ffn_dim = 2 if name in ("wi", "wg") else 1
            put(ffn_dim, "model", model)
        other = 2 if spec[2] is None else 1
        put(other, "data", data)
    elif name in ("wi", "wg") and nd == 2:
        put(1, "model", model)          # d_ff (column-parallel)
        put(0, "data", data)
    elif name == "wo" and nd == 2:
        put(0, "model", model)          # d_ff (row-parallel, contracted)
        put(1, "data", data)
    elif name == "router" and nd == 2:
        put(0, "data", data)
    elif name == "in_proj" and nd == 2:
        put(1, "model", model)          # fused z/x/B/C/dt outputs
        put(0, "data", data)
    elif name == "out_proj" and nd == 2:
        put(0, "model", model)          # d_inner (contracted)
        put(1, "data", data)
    elif name == "conv_w" and nd == 2:
        put(1, "data", data)
    elif name == "embed" and nd == 2:
        put(0, "model", model)          # vocab
        put(1, "data", data)
    elif name == "head" and nd == 2:
        put(1, "model", model)          # vocab
        put(0, "data", data)
    elif name == "projector" and nd == 2:
        put(0, "data", data)
    else:
        matched = False
    if not matched:
        return None
    return [None] * start + spec


def param_specs(params: Any, mesh, profile: str = "default") -> Any:
    """Specs for a parameter/optimizer tree (name-aware tensor-parallel
    rules + generic divisibility fallback).

    profile="replicate_model": no tensor parallelism — params replicated
    over "model", sharded over "data" only (FSDP).
    """
    def spec_for(pstr, leaf):
        if not _is_array(leaf):
            return ()
        shape = tuple(leaf.shape)
        ndim = len(shape)
        start = 1 if any(m in pstr for m in STACKED_MARKERS) \
            and ndim > 1 else 0
        if profile == "replicate_model":
            data = mesh_axis_sizes(mesh).get("data", 1)
            spec = [None] * ndim
            cands = [i for i in range(start, ndim)
                     if shape[i] % data == 0 and shape[i] >= data]
            if cands and data > 1:
                spec[max(cands, key=lambda i: shape[i])] = "data"
            return tuple(spec)
        named = _named_param_spec(pstr, shape, start, mesh)
        if named is not None:
            return tuple(named)
        return tuple(_assign(shape, start, mesh))

    return tree_map_with_path(spec_for, params)


def _data_axes(mesh) -> Tuple[Tuple[str, ...], int]:
    sizes = mesh_axis_sizes(mesh)
    daxes = tuple(a for a in ("pod", "data") if sizes.get(a, 1) > 1)
    return daxes, math.prod(sizes[a] for a in daxes)


def batch_specs(batch: Any, mesh) -> Any:
    """Batch leaves: leading (global-batch) dim over ("pod","data")."""
    sizes = mesh_axis_sizes(mesh)
    daxes, dsize = _data_axes(mesh)

    def spec_for(_pstr, leaf):
        if not _is_array(leaf):
            return ()
        n = leaf.shape[0]
        if daxes and n % dsize == 0 and n >= dsize:
            return (daxes if len(daxes) > 1 else daxes[0],)
        # batch not divisible by pod*data: try data alone
        if "data" in daxes and n % sizes["data"] == 0 and n >= sizes["data"]:
            return ("data",)
        return ()

    return tree_map_with_path(spec_for, batch)


def decode_state_specs(state: Any, mesh, batch: int,
                       profile: str = "default") -> Any:
    """Decode-state leaves: (L, B, ...) caches -> B over ("pod","data"),
    heads/head_dim over "model".  profile="replicate_model": batch only."""
    model = mesh_axis_sizes(mesh).get("model", 1)
    daxes, dsize = _data_axes(mesh)

    def spec_for(pstr, leaf):
        if not _is_array(leaf):
            return ()
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        # find the batch dim (first dim == batch after the stacked L dim)
        bdim = None
        for i, d in enumerate(shape[:2]):
            if d == batch:
                bdim = i
                break
        if bdim is not None and daxes and batch % dsize == 0 \
                and batch >= dsize:
            spec[bdim] = daxes if len(daxes) > 1 else daxes[0]
        if profile == "replicate_model":
            return tuple(spec)
        if model > 1:
            if "kv" in pstr and len(shape) == 5 and bdim is not None:
                # KV caches (L, B, C, KVH, HD): the cache-length dim over
                # "model" (few-KV-head GQA cannot shard heads 16-way)
                if shape[2] % model == 0 and shape[2] >= model:
                    spec[2] = "model"
                    return tuple(spec)
            # fallback: first divisible trailing dim
            for i in range(len(shape) - 1,
                           (bdim if bdim is not None else 0), -1):
                if spec[i] is None and shape[i] % model == 0 \
                        and shape[i] >= model:
                    spec[i] = "model"
                    break
        return tuple(spec)

    return tree_map_with_path(spec_for, state)


def to_placements(specs: Any, mesh) -> Any:
    """A tree of specs as DTensor placements on ``mesh`` (a
    ``DeviceMesh``), leaf for leaf."""
    if isinstance(specs, dict):
        return {k: to_placements(v, mesh) for k, v in specs.items()}
    if specs is None:
        return None
    return _placements(specs, mesh)


def distribute_tree(tree: Any, specs: Any, mesh) -> Any:
    """Each tensor of ``tree`` as a DTensor on ``mesh`` by its spec of
    ``specs`` (a tree of the same structure); other leaves as they are.
    Every rank holds the whole tree (drawn from one seed, or loaded), so
    each takes its own shard with no communication."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(tree, dict):
        return {k: distribute_tree(v, specs[k], mesh) for k, v in tree.items()}
    if not hasattr(tree, "shape"):
        return tree
    return distribute_tensor(tree, mesh, _placements(specs, mesh),
                             src_data_rank=None)
