"""Roofline terms of a traced dry-run step on the NVIDIA H100 (port of
``repro.analysis.roofline``, whose target is the TPU v5e):

    compute term    = FLOPs / peak bf16 FLOP/s           (per device)
    memory term     = bytes / HBM bandwidth              (per device)
    collective term = collective bytes / link bandwidth  (per device)

The rates are published data-sheet numbers (``utils/constants.py``), not
measurements: these terms are models.  The collective term takes the
InfiniBand NDR rate of one GPU where the mesh spans nodes (every
production mesh: 256 or 512 GPUs, 8 to a node) and NVLink 4's within a
node of 8.  The bytes are eager mode's, every op counted (``op_cost.py``),
so the memory term reads higher than a fused program's would; that is the
counting, not a fault.  MODEL_FLOPS (6·N·D train / 2·N·D prefill /
2·N_active·B decode) over the counted FLOPs is the useful share (remat,
padding and replicated work lower it).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.analysis.op_cost import Cost
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.utils import constants

GPUS_PER_NODE = 8


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    op_flops: float                # per device
    op_bytes: float                # per device
    coll_bytes: float              # per device
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_total: float       # whole job, analytic
    useful_flop_ratio: float       # model_flops/chips / op_flops
    bytes_per_device: Optional[float] = None
    coll_breakdown: Optional[Dict[str, float]] = None

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_seconds(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "useful_flop_ratio": self.useful_flop_ratio,
            "op_flops": self.op_flops, "op_bytes": self.op_bytes,
            "coll_bytes": self.coll_bytes,
            "bytes_per_device": self.bytes_per_device,
        }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Analytic useful FLOPs per step for the whole job."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def link_bandwidth(chips: int) -> float:
    """Bytes/s a device sends to its peers: NVLink 4 within one node,
    InfiniBand NDR where the mesh spans nodes (data-sheet rates)."""
    if chips <= GPUS_PER_NODE:
        return constants.DATASHEET_NVLINK_BANDWIDTH
    return constants.DATASHEET_IB_NDR_BANDWIDTH


def build_report(arch: str, shape_cfg: ShapeConfig, mesh_name: str,
                 chips: int, cost: Cost, cfg: ModelConfig,
                 memory_stats: Optional[Dict] = None) -> RooflineReport:
    """The three terms from ``op_cost``'s per-device counts."""
    mf = model_flops(cfg, shape_cfg)
    return RooflineReport(
        arch=arch, shape=shape_cfg.name, mesh=mesh_name, chips=chips,
        op_flops=cost.flops, op_bytes=cost.bytes, coll_bytes=cost.coll_bytes,
        compute_s=cost.flops / constants.DATASHEET_PEAK_BF16_FLOPS,
        memory_s=cost.bytes / constants.DATASHEET_HBM_BANDWIDTH,
        collective_s=cost.coll_bytes / link_bandwidth(chips),
        model_flops_total=mf,
        useful_flop_ratio=(mf / chips) / cost.flops if cost.flops else 0.0,
        bytes_per_device=(memory_stats or {}).get("bytes_per_device"),
        coll_breakdown=dict(cost.coll_by_type))
