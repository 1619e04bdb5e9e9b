"""In-graph sharding constraints for model internals (port of
``repro.parallel.constraints``).

Under a mesh the model's tensors are DTensors, and DTensor's sharding
propagation picks each op's output placement from its inputs'.  Through
the reshapes of attention, the MoE dispatch and the SSD blocks it loses the
head, FFN and batch partitioning, as XLA's does.  ``constrain`` pins the
intended layout: it redistributes a DTensor to the spec under the ambient
mesh (``use_mesh``, the counterpart of JAX's ``with mesh:``).

``constrain`` is a no-op on plain tensors and outside a mesh, so every
single-device path, the kernels' included, runs as it did; and it drops
axes that do not divide the dimension, so model code can state intent
unconditionally.  A spec is a tuple with one entry per tensor dim: None,
a mesh-axis name, or a tuple of names (JAX's ``PartitionSpec`` order).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

BATCH = ("pod", "data")      # global-batch sharding axes
MODEL = "model"

# Perf toggle (paired with param_specs profile="replicate_model"): drop
# "model" from activation constraints so small models run pure-DP.
DISABLE_MODEL_CONSTRAINTS = False

_MESHES: List = []


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator:
    """Make ``mesh`` (a ``DeviceMesh``) the ambient mesh of the block.

    Inside it a plain tensor meeting a DTensor in an op counts as
    replicated (DTensor's ``implicit_replication``): the index ranges,
    masks and rotary tables the model makes on the fly, which JAX's
    tracer replicates likewise."""
    from torch.distributed.tensor.experimental import implicit_replication

    _MESHES.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESHES.pop()


def current_mesh():
    """The ambient mesh, or None outside ``use_mesh``."""
    return _MESHES[-1] if _MESHES else None


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of any object with
    ``axis_names`` and ``shape`` (``launch.mesh.MeshShape``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = mesh.axis_names
    return dict(zip(names, tuple(mesh.shape)))


def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _axes(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def clean_spec(shape: Sequence[int], spec: Sequence[Axis],
               sizes: Dict[str, int]) -> Spec:
    """JAX's guards: axes absent from the mesh or of size 1 are dropped; an
    entry whose axes do not divide the dim drops its leading axis if the
    rest divides it (a partial fit), else replicates the dim."""
    clean = []
    for dim, s in zip(shape, spec):
        if s is None or (DISABLE_MODEL_CONSTRAINTS and s == MODEL):
            clean.append(None)
            continue
        axes = tuple(a for a in _axes(s) if sizes.get(a, 1) > 1)
        total = math.prod(sizes[a] for a in axes)
        if not axes or total <= 1 or dim % total != 0 or dim < total:
            if len(axes) > 1:
                sub = axes[1:]
                t2 = math.prod(sizes[a] for a in sub)
                if dim % t2 == 0 and dim >= t2:
                    clean.append(sub if len(sub) > 1 else sub[0])
                    continue
            clean.append(None)
            continue
        clean.append(axes if len(axes) > 1 else axes[0])
    return tuple(clean)


def to_placements(spec: Sequence[Axis], mesh) -> list:
    """DTensor placements, one per mesh dim, of a spec (the counterpart of
    JAX's ``NamedSharding``): ``Shard(d)`` on each mesh dim named in tensor
    dim d's entry, ``Replicate()`` on the others.  A tensor dim split over
    several mesh axes takes them in the mesh's order, major first, as JAX's
    tuple entries do."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dims of "
                                 f"{tuple(spec)}")
            out[i] = Shard(d)
    return out


def constrain(x, *spec: Axis):
    """Redistribute the DTensor ``x`` to ``spec`` under the ambient mesh,
    with divisibility and axis-existence guards; ``x`` as it is when it is
    not a DTensor, outside a mesh, or when ``spec`` has another rank."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x) or x.ndim != len(spec):
        return x
    dm = x.device_mesh
    clean = clean_spec(x.shape, spec, mesh_axis_sizes(dm))
    placements = tuple(to_placements(clean, dm))
    if tuple(x.placements) != placements:
        x = x.redistribute(dm, placements)
    return _PinCotangent.apply(x, placements)


def pin(x):
    """``x`` whose gradient is put in ``x``'s own placements where it
    arrives (a no-op on plain tensors or outside a mesh): for a parameter
    used twice (the tied embedding and head), so that the two gradients
    meet in one placement before autograd adds them."""
    if current_mesh() is None or not is_dtensor(x):
        return x
    return _PinCotangent.apply(x, tuple(x.placements))


class _PinCotangent(torch.autograd.Function):
    """Identity whose backward puts the cotangent in the same placements,
    as ``with_sharding_constraint``'s transpose does in JAX.  Without it a
    gradient that arrives as partial sums stays so (DTensor defers the
    reduction), and the products of the backward then gather their
    weights in full."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g, None


def local_size(mesh: Optional[object], axis: str) -> int:
    """The size of ``axis`` in ``mesh`` (1 without a mesh or the axis)."""
    return mesh_axis_sizes(mesh).get(axis, 1) if mesh is not None else 1


def placements_for(x, spec: Sequence[Axis], partial: Sequence[str] = (),
                   shape: Optional[Sequence[int]] = None) -> list:
    """``spec`` cleaned for ``shape`` (``x``'s by default) under the
    ambient mesh, as placements; mesh axes in ``partial`` hold partial sums
    (``Partial``)."""
    from torch.distributed.tensor import Partial

    mesh = current_mesh()
    shape = x.shape if shape is None else shape
    out = to_placements(clean_spec(shape, spec, mesh_axis_sizes(mesh)), mesh)
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in partial:
            out[i] = Partial()
    return out


def shard_map(fn, args: Sequence, in_specs: Sequence[Spec], out_specs,
              partial: Sequence[str] = ()):
    """``fn`` on the local shards of ``args`` under the ambient mesh (JAX's
    ``shard_map``, through DTensor's ``local_map``): each DTensor argument
    is redistributed to its spec first (plain arguments pass as they are),
    and each output of ``fn`` (a tuple, one entry per ``out_specs``) comes
    back as a DTensor.  An entry of ``out_specs`` is an int, for the
    placements argument i was given, or a (spec, global shape) pair; the
    mesh axes in ``partial`` hold partial sums, which a later ``constrain``
    reduces (JAX's ``psum``).  Without a mesh, or on plain tensors, it is
    ``fn(*args)``."""
    from torch.distributed.tensor.experimental import local_map

    mesh = current_mesh()
    if mesh is None or not any(is_dtensor(a) for a in args):
        return fn(*args)
    in_pl = tuple(placements_for(a, sp) if is_dtensor(a) else None
                  for a, sp in zip(args, in_specs))
    out_pl = []
    for o in out_specs:
        if isinstance(o, int):
            pl = placements_for(args[o], in_specs[o], partial)
        else:
            pl = placements_for(None, o[0], partial, shape=o[1])
        out_pl.append(pl)
    return local_map(fn, out_placements=tuple(out_pl), in_placements=in_pl,
                     in_grad_placements=_grad_placements(in_pl, out_pl),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def _grad_placements(in_pl, out_pl):
    """The placements of each input's gradient: partial sums over every
    mesh dim on which the input is replicated while the work is split
    (another input or an output is sharded or partial there), so that the
    devices' local gradients add up (JAX's ``shard_map`` transposes a
    replicated input into a ``psum``); the input's own elsewhere."""
    from torch.distributed.tensor import Partial, Replicate

    split = {i for pl in [p for p in in_pl if p is not None] + list(out_pl)
             for i, p in enumerate(pl) if not isinstance(p, Replicate)}
    return tuple(None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and i in split else p
        for i, p in enumerate(pl)) for pl in in_pl)
