"""Sweep runner: baseline dry-run for every (arch x shape x mesh) (port of
``repro.launch.dryrun_all``).

Each combination runs in its own subprocess (``python -m
repro_torch.launch.dryrun``: a fake world is a process's own) with bounded
parallelism.  Results land in ``results/dryrun_torch/<arch>.<shape>.
<mesh>.json``; ``--table`` prints the roofline summary.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_all --mesh both -j 4
    PYTHONPATH=src python -m repro_torch.launch.dryrun_all --table
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import List, Tuple

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs.base import INPUT_SHAPES

RESULTS = "results/dryrun_torch"
SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def result_path(arch: str, shape: str, mesh: str) -> str:
    return os.path.join(RESULTS, f"{arch}.{shape}.{mesh}.json")


def run_one(arch: str, shape: str, mesh: str, timeout: int = 1500,
            force: bool = False) -> Tuple[str, str]:
    out = result_path(arch, shape, mesh)
    if os.path.exists(out) and not force:
        return (out, "cached")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh, "--out", out]
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    os.makedirs(RESULTS, exist_ok=True)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout, env=env)
    except subprocess.TimeoutExpired:
        with open(out, "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "timeout"}, f)
        return (out, "timeout")
    if proc.returncode != 0:
        with open(out, "w") as f:
            json.dump({"arch": arch, "shape": shape, "mesh": mesh,
                       "status": "error", "stderr": proc.stderr[-4000:]},
                      f, indent=2)
        return (out, "error")
    return (out, "ok")


def all_pairs(meshes: List[str]) -> List[Tuple[str, str, str]]:
    return [(a, s.name, m) for a in ASSIGNED_ARCHS for s in INPUT_SHAPES
            for m in meshes]


def print_table() -> None:
    rows = []
    for a in ASSIGNED_ARCHS:
        for s in INPUT_SHAPES:
            for m in ("single", "multi"):
                p = result_path(a, s.name, m)
                if not os.path.exists(p):
                    continue
                with open(p) as f:
                    r = json.load(f)
                if r.get("status") == "skipped":
                    rows.append((a, s.name, m, "SKIP", r["reason"][:40],
                                 "", "", "", ""))
                elif r.get("status") != "ok":
                    rows.append((a, s.name, m, r.get("status", "?").upper(),
                                 "", "", "", "", ""))
                else:
                    rf = r["roofline"]
                    rows.append((
                        a, s.name, m, rf["dominant"],
                        f"{rf['compute_s']:.3g}", f"{rf['memory_s']:.3g}",
                        f"{rf['collective_s']:.3g}",
                        f"{rf['useful_flop_ratio']:.3f}",
                        f"{r['memory']['bytes_per_device'] / 1e9:.1f}"))
    hdr = ("arch", "shape", "mesh", "dominant", "compute_s", "memory_s",
           "coll_s", "useful", "GB/device")
    widths = [max(len(str(row[i])) for row in rows + [hdr])
              for i in range(len(hdr))]
    print("  ".join(h.ljust(w) for h, w in zip(hdr, widths)))
    for row in rows:
        print("  ".join(str(c).ljust(w) for c, w in zip(row, widths)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("-j", "--jobs", type=int, default=3)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--table", action="store_true")
    ap.add_argument("--arch", default=None)
    args = ap.parse_args(argv)

    if args.table:
        print_table()
        return
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    pairs = all_pairs(meshes)
    if args.arch:
        pairs = [p for p in pairs if p[0] == args.arch]
    done = 0
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        futs = {ex.submit(run_one, a, s, m, force=args.force): (a, s, m)
                for a, s, m in pairs}
        for fut in as_completed(futs):
            a, s, m = futs[fut]
            _, status = fut.result()
            done += 1
            print(f"[{done}/{len(pairs)}] {a} x {s} [{m}] -> {status}",
                  flush=True)


if __name__ == "__main__":
    main()
