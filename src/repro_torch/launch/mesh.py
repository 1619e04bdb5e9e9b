"""Production mesh construction (port of ``repro.launch.mesh``).

Functions, not module-level constants: a ``DeviceMesh`` needs the caller's
process group (``torch.distributed.init_process_group``), of the mesh's
size.  ``MeshShape`` carries only the axis names and sizes, which is all
the placement rules read, for planning where no process group exists.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

SINGLE_POD_SHAPE = (16, 16)          # ("data", "model") — 256 devices
MULTI_POD_SHAPE = (2, 16, 16)        # ("pod", "data", "model") — 512


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, with no devices behind them."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def production_shape(multi_pod: bool = False) -> MeshShape:
    if multi_pod:
        return MeshShape(("pod", "data", "model"), MULTI_POD_SHAPE)
    return MeshShape(("data", "model"), SINGLE_POD_SHAPE)


def make_mesh(shape: MeshShape, device_type: str = "cpu"):
    """``init_device_mesh`` over ``shape`` in the caller's world."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape.shape),
                            mesh_dim_names=tuple(shape.axis_names))


def make_production_mesh(multi_pod: bool = False, device_type: str = "cuda"):
    """(16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model"),
    in a world of 256 or 512 ranks that the caller has set up."""
    return make_mesh(production_shape(multi_pod), device_type)


def make_local_mesh(device_type: str = "cuda"):
    """1 x 1 ("data", "model") mesh in a world of one rank."""
    return make_mesh(MeshShape(("data", "model"), (1, 1)), device_type)
