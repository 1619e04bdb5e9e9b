"""Multi-pod dry-run: trace every (arch x shape) on the production meshes
without running it, and extract the roofline terms (port of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \
        --shape train_4k --mesh single --splice 1 \
        --out results/dryrun_torch/yi-9b.train_4k.single.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmo-1b \
        --smoke train --mesh-shape 2,2      # smoke config, B 8 x S 64

JAX lowers and compiles the pair for 256 or 512 host devices.  Here one
process joins a fake world of the mesh's size (``torch.distributed``'s
"fake" backend: collectives return at once) as rank 0, builds the
``DeviceMesh``, distributes the abstract state and batch by
``parallel/sharding.py``'s specs, and runs the train step (forward,
backward, update), ``prefill_fn`` or ``decode_step_fn`` under
``FakeTensorMode``: every tensor has its shape and no storage, so nothing
of the full-size state is allocated.  ``analysis/op_cost.py`` counts the
ops rank 0 runs, from its local shards (the mesh is symmetric), and the
bytes live at once.

The models call the six kernels through their ``torch.library`` ops
(``kernels/_library.py``), which run their fake implementations on fake
tensors: the trace holds what each kernel holds on the card (its
outputs), where the plain versions would hold their whole score matrices,
and ``op_cost.py`` counts each op by its formula (``swa_flash`` and
``swa_flash_bwd`` their causal pairs, not the dense S x S products).  So the trace plans the
kernel path the card runs, as JAX's dry-run lowers the path its TPU runs.

The record has JAX's keys where they mean the same thing;
``trace_seconds`` stands for ``lower_seconds`` and ``compile_seconds``,
``op_cost`` for ``hlo_cost`` (with ``bytes_lower``, the write-once bound),
``aten_ops`` for ``hlo_ops`` (the kernels' ops among them by name), and
there is no ``xla_cost_analysis``; ``kernel_ops`` counts the kernels'
ops.  ``memory`` holds ``argument_size_in_bytes`` (the local state and
batch), ``output_size_in_bytes`` (the local results),
``alias_size_in_bytes`` (the donated state: outputs written into
arguments), ``temp_size_in_bytes`` and ``bytes_per_device`` = argument +
output + temp - alias, the most bytes live at once.

The fake world is this process's: ``lower_pair`` destroys the process
group it made before it returns, even on an error, and refuses to run
inside a world it did not make.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Dict, Optional

import torch
from torch.utils._pytree import tree_leaves

from repro_torch.analysis.ops import collective_bytes, op_histogram
from repro_torch.analysis.op_cost import OpCost
from repro_torch.analysis.roofline import build_report
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.launch.mesh import MeshShape, make_mesh, production_shape
from repro_torch.launch.specs import (decode_specs, input_specs, plan_pair,
                                      state_specs)
from repro_torch.models import decode_step_fn, prefill_fn
from repro_torch.parallel import constraints as _constraints
from repro_torch.parallel.constraints import use_mesh
from repro_torch.parallel.sharding import (batch_specs, decode_state_specs,
                                           distribute_tree, param_specs)
from repro_torch.training.step import build_train_step
from repro_torch.utils.tree import tree_map


def _fake(tree, mode):
    """The meta tree as fake CPU tensors of ``mode`` (no storage)."""
    def leaf(t):
        if not isinstance(t, torch.Tensor):
            return t
        with mode:
            return torch.empty(t.shape, dtype=t.dtype)
    return tree_map(leaf, tree)


def _local_bytes(tree) -> int:
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = getattr(t, "_local_tensor", t)
            total += local.numel() * local.element_size()
    return total


def lower_pair(arch: str, shape_name: str, multi_pod: bool,
               splice: int = 1, remat: bool = True, donate: bool = False,
               remat_policy: str = "full", shard_profile: str = "default",
               moe_capacity_factor: Optional[float] = None,
               fused_gate: bool = False,
               mesh_override: Optional[tuple] = None,
               extra_tags: Optional[Dict] = None, *,
               config: Optional[ModelConfig] = None,
               shape_config: Optional[ShapeConfig] = None) -> Dict:
    """Trace one pair on one mesh; returns the result record.  ``config``
    and ``shape_config`` replace the pair's (a smoke-size trace)."""
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.models import moe as _moe

    plan = plan_pair(arch, shape_name)
    mesh_name = "multi" if multi_pod else "single"
    if plan.skip_reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": plan.skip_reason}
    cfg = config if config is not None else plan.cfg
    shape = shape_config if shape_config is not None else plan.shape
    if moe_capacity_factor is not None and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=moe_capacity_factor))
    mshape = (MeshShape(("data", "model"), tuple(mesh_override))
              if mesh_override is not None else production_shape(multi_pod))
    chips = mshape.size
    tcfg = TrainConfig(remat=remat, remat_policy=remat_policy)
    if dist.is_initialized():
        raise RuntimeError("lower_pair makes its own fake world; a process "
                           "group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=chips)
    _moe.FUSED_GATE = fused_gate
    _constraints.DISABLE_MODEL_CONSTRAINTS = \
        shard_profile == "replicate_model"
    try:
        mesh = make_mesh(mshape, "cpu")
        mode = FakeTensorMode()
        t0 = time.time()
        state = _fake(state_specs(cfg, tcfg), mode)
        params = state["params"]
        with mode:
            if shape.kind == "decode":
                dstate = _fake(decode_specs(cfg, shape), mode)
                d_sh = distribute_tree(dstate, decode_state_specs(
                    dstate, mesh, shape.global_batch, shard_profile), mesh)
                p_sh = distribute_tree(params, param_specs(
                    params, mesh, shard_profile), mesh)
                tok = _fake(input_specs(cfg, shape), mode)
                t_sh = distribute_tree(tok, batch_specs(tok, mesh), mesh)
                args = (p_sh, d_sh, t_sh)
                alias = _local_bytes(d_sh) if donate else 0
            else:
                batch = _fake(input_specs(cfg, shape), mode)
                b_sh = distribute_tree(batch, batch_specs(batch, mesh), mesh)
                if shape.kind == "train":
                    st = distribute_tree(state, param_specs(
                        state, mesh, shard_profile), mesh)
                    args = (st, b_sh)
                    alias = _local_bytes(st) if donate else 0
                else:
                    p_sh = distribute_tree(params, param_specs(
                        params, mesh, shard_profile), mesh)
                    args = (p_sh, b_sh)
                    alias = 0
            del state, params
            counter = OpCost()
            argument = counter.track(tree_leaves(args))
            with counter, use_mesh(mesh):
                if shape.kind == "train":
                    step = build_train_step(cfg, tcfg, splice=splice,
                                            donate=donate)
                    out = step(*args)
                elif shape.kind == "prefill":
                    out = prefill_fn(args[0], args[1], cfg)
                else:
                    p_sh, d_sh, t_sh = args
                    if not donate:   # a new state: copy the donated one
                        d_sh = tree_map(lambda t: t.clone()
                                        if isinstance(t, torch.Tensor)
                                        else t, d_sh)
                    out = decode_step_fn(p_sh, d_sh, t_sh["token"], cfg)
        trace_s = time.time() - t0
    finally:
        _moe.FUSED_GATE = False
        _constraints.DISABLE_MODEL_CONSTRAINTS = False
        dist.destroy_process_group()

    output = _local_bytes(out)
    peak = counter.peak_bytes
    mem = {"argument_size_in_bytes": argument,
           "output_size_in_bytes": output,
           "alias_size_in_bytes": alias,
           "temp_size_in_bytes": max(0, peak - argument - output + alias),
           "bytes_per_device": peak}
    report = build_report(arch, shape, mesh_name, chips, counter.cost, cfg,
                          mem)
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": chips, "splice": splice,
        "mesh_shape": list(mshape.shape), "donate": donate,
        "swa_variant": plan.swa_variant,
        "trace_seconds": round(trace_s, 2),
        "memory": mem,
        "op_cost": counter.cost.as_dict(),
        "collectives": collective_bytes(counter),
        "roofline": report.row(),
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "aten_ops": op_histogram(counter, top=25),
        "kernel_ops": dict(counter.kernels),
    }
    if extra_tags:
        rec.update(extra_tags)
    return rec


def lower_smoke(arch: str, kind: str, mesh: tuple, donate: bool = False,
                seq_len: int = 64, global_batch: int = 8) -> Dict:
    """``lower_pair`` of the arch's smoke config on a (data, model) mesh, for
    a step of ``kind`` (train, prefill or decode) at the given sizes."""
    from repro_torch.configs import get_smoke_config

    return lower_pair(arch, "train_4k", multi_pod=False, donate=donate,
                      mesh_override=tuple(mesh),
                      config=get_smoke_config(arch),
                      shape_config=ShapeConfig(f"smoke_{kind}", seq_len,
                                               global_batch, kind))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--mesh-shape", default=None,
                    help="data,model (overrides --mesh), e.g. 1,1")
    ap.add_argument("--splice", type=int, default=1)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--donate", action="store_true")
    ap.add_argument("--smoke", default=None, metavar="KIND",
                    help="trace the smoke config's train, prefill or decode "
                         "step at --seq-len x --global-batch (needs "
                         "--mesh-shape)")
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=None,
                    help="the smoke step's batch (default 8); with a pair's "
                         "shape, replaces its global batch")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the pair's config to this many layers, widths "
                         "kept (0: keep), as train.py --layers")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    override = (tuple(int(x) for x in args.mesh_shape.split(","))
                if args.mesh_shape else None)
    if args.smoke:
        if override is None:
            ap.error("--smoke needs --mesh-shape")
        rec = lower_smoke(args.arch, args.smoke, override, args.donate,
                          args.seq_len, args.global_batch or 8)
    else:
        plan = plan_pair(args.arch, args.shape)
        cfg = shape = None
        if args.layers and plan.cfg is not None:
            cfg = dataclasses.replace(plan.cfg, num_layers=args.layers)
        if args.global_batch and plan.shape is not None:
            shape = dataclasses.replace(plan.shape,
                                        global_batch=args.global_batch)
        rec = lower_pair(args.arch, args.shape,
                         multi_pod=(args.mesh == "multi"),
                         splice=args.splice, remat=not args.no_remat,
                         donate=args.donate, mesh_override=override,
                         config=cfg, shape_config=shape)
    text = json.dumps(rec, indent=2, default=str)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    if rec.get("status") == "ok":
        rf = rec["roofline"]
        print(f"{args.arch} x {args.shape} [{args.mesh}] OK "
              f"chips={rec['chips']} trace={rec['trace_seconds']}s "
              f"dominant={rf['dominant']}")
        print("memory:", rec["memory"])
        print("kernel ops:", rec["kernel_ops"])
        print("op_cost:", {k: f"{v:.3e}" for k, v in rec["op_cost"].items()
                           if isinstance(v, float)})
        print("roofline:", {k: (f"{v:.4g}" if isinstance(v, float) else v)
                            for k, v in rf.items()
                            if k in ("compute_s", "memory_s", "collective_s",
                                     "dominant", "useful_flop_ratio",
                                     "bytes_per_device")})
    else:
        print(f"{args.arch} x {args.shape} [{args.mesh}] SKIPPED: "
              f"{rec['reason']}")
    if not args.out:
        print(text)


if __name__ == "__main__":
    main()
