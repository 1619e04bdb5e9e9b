"""Perf hillclimb runner: trace a pair under a named variant and diff the
roofline terms against the baseline (port of ``repro.launch.hillclimb``).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb \\
        --arch yi-9b --shape decode_32k --variant donate

Variants, joined with ``+``:
  baseline          — as the sweep
  donate            — donate the state (outputs written into the inputs)
  spliceN           — time-slice the step (activation live-set control)
  noremat           — disable activation checkpointing
  dotsremat         — remat policy "dots" (save matmul outputs)
  nomodeltp         — no tensor parallelism (profile "replicate_model")
  cfNN              — MoE capacity factor NN / 100
  fusedgate         — fused wi/wg expert up-projection
  chipsN            — right-size the mesh: data 16, model N / 16 (or N x 1)
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.launch.dryrun import lower_pair


def variant_kwargs(variant: str) -> dict:
    """``lower_pair``'s keyword arguments for ``variant``."""
    kw = dict(splice=1, remat=True, donate=False, remat_policy="full",
              shard_profile="default", moe_capacity_factor=None,
              fused_gate=False, mesh_override=None)
    for part in variant.split("+"):
        if part.startswith("splice"):
            kw["splice"] = int(part[len("splice"):])
        elif part == "noremat":
            kw["remat"] = False
        elif part == "donate":
            kw["donate"] = True
        elif part == "dotsremat":
            kw["remat_policy"] = "dots"
        elif part == "nomodeltp":
            kw["shard_profile"] = "replicate_model"
        elif part.startswith("cf"):
            kw["moe_capacity_factor"] = float(part[2:]) / 100.0
        elif part == "fusedgate":
            kw["fused_gate"] = True
        elif part.startswith("chips"):
            n = int(part[len("chips"):])
            # keep data=16 (batch sharding), shrink TP
            kw["mesh_override"] = (16, n // 16) if n >= 16 else (n, 1)
        elif part == "baseline":
            pass
        else:
            raise ValueError(part)
    return kw


def run_variant(arch: str, shape: str, mesh: str, variant: str) -> dict:
    return lower_pair(arch, shape, multi_pod=(mesh == "multi"),
                      extra_tags={"variant": variant},
                      **variant_kwargs(variant))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--variant", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rec = run_variant(args.arch, args.shape, args.mesh, args.variant)
    out = args.out or (f"results/perf_torch/{args.arch}.{args.shape}."
                       f"{args.mesh}.{args.variant}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=2, default=str)
    print(f"{args.arch} x {args.shape} [{args.mesh}] variant={args.variant}")
    if rec.get("status") != "ok":
        print(f"  {rec['status']}: {rec.get('reason', '')}")
        return
    rf = rec["roofline"]
    print(f"  compute={rf['compute_s']:.4g}s memory={rf['memory_s']:.4g}s "
          f"collective={rf['collective_s']:.4g}s dominant={rf['dominant']} "
          f"useful={rf['useful_flop_ratio']:.3f}")
    mem = rec["memory"]
    print(f"  temp {mem['temp_size_in_bytes'] / 1e9:.2f} GB "
          f"args {mem['argument_size_in_bytes'] / 1e9:.2f} GB "
          f"alias {mem['alias_size_in_bytes'] / 1e9:.2f} GB")


if __name__ == "__main__":
    main()
