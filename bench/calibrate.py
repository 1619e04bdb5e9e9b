"""Readings that set a cell's limits of ``correct``: the program against
the reference on many seeds, and the control and the planted faults on a
few, at the cell's own sizes, in one process.

    python3 bench/calibrate.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--out <file>]

Prints one JSON line a reading, the four numbers of ``judge.gaps``:

- ``program``: the program's first steps against the f32 reference;
- ``control``: the reference in fp8 (the precision below the bf16 the
  configuration states) in the program's place;
- ``half``: the reference on the first half of each batch (the mean over
  the rest) in the program's place;
- ``last_slice`` (splice over 1): the reference on the last slice only,
  the slices' gradient sum left out;
- ``unchanged``: a step that returns its state unchanged.  It reads 1
  on ``grad1_gap``, ``embed_grad1_gap`` and ``change_gap`` (the moments
  and the parameters stay as drawn); its ``loss_gap`` is read from the
  reference at learning rate 0, each batch's loss on the drawn weights.

The benchmark's own runs never run these.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from bench import harness, judge

    if not torch.cuda.is_available():
        print("[calibrate] no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(seed, variant, numbers, seconds, **extra):
        line = json.dumps({"cell": cell.name, "seed": seed,
                           "variant": variant, **numbers,
                           "seconds": seconds, **extra})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        rt = harness.build(cell, seed, "cuda")
        prog = harness.first_steps(rt, cell, seed, "cuda")
        del rt
        harness.free()
        t1 = time.perf_counter()
        ref = harness.reference_readings(cell, seed, "cuda")
        harness.free()
        emit(seed, "program", judge.gaps(prog, ref),
             time.perf_counter() - t1, program_s=t1 - t0,
             losses=prog["losses"], ref_losses=ref["losses"],
             grad1=prog["grad1"], ref_grad1=ref["grad1"],
             change=prog["change"],
             ref_change=ref["change"])
        if seed not in controls:
            continue
        half = cell.traffic["global_batch"] // 2
        still = dataclasses.replace(cell, job=dict(cell.job, optim=dict(
            cell.job["optim"], learning_rate=0.0)))
        variants = {"control": (cell, dict(matmul="fp8")),
                    "half": (cell, dict(rows=slice(0, half),
                                        splice=max(1, cell.splice // 2))),
                    "unchanged": (still, {})}
        if cell.splice > 1:
            variants["last_slice"] = (cell, dict(
                rows=slice(cell.traffic["global_batch"]
                           - cell.rows_per_slice, None), splice=1))
        for name, (c, kw) in variants.items():
            t2 = time.perf_counter()
            fault = harness.reference_readings(c, seed, "cuda", **kw)
            harness.free()
            if name == "unchanged":
                fault["grad1"] = dict.fromkeys(fault["grad1"], 0.0)
            emit(seed, name, judge.gaps(fault, ref),
                 time.perf_counter() - t2, losses=fault["losses"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
