"""The dry-run's roofline tables from ``results/dryrun_torch/`` (port of
``repro.analysis.report``).

    PYTHONPATH=src python -m repro_torch.analysis.report > results/roofline_torch.md

The terms are data-sheet models of an H100 fleet (``analysis/roofline.py``),
not measurements.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.configs.base import INPUT_SHAPES

RESULTS = "results/dryrun_torch"


def load(arch: str, shape: str, mesh: str) -> Optional[Dict]:
    p = os.path.join(RESULTS, f"{arch}.{shape}.{mesh}.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.3g}us"
    if x < 1:
        return f"{x * 1e3:.3g}ms"
    return f"{x:.3g}s"


def one_liner(r: Dict) -> str:
    """What would move the dominant term down (per-pair note)."""
    dom = r["roofline"]["dominant"]
    shape = r["shape"]
    if dom == "memory":
        if "decode" in shape or shape == "long_500k":
            return ("memory-bound on cache reads: quantize the KV cache / "
                    "write the cache slot in place (donate the state)")
        return ("memory-bound on activations (eager bytes, every op "
                "counted): the attention and CE kernels' fusion, a higher "
                "splice factor to shrink the live set, bf16 norm statistics")
    if dom == "collective":
        return ("collective-bound: reduce-scatter gradients instead of "
                "all-reduce, overlap FSDP all-gathers with compute, shard "
                "experts deeper, keep the mesh inside NVLink")
    return ("compute-bound (near roofline): raise arithmetic intensity via "
            "longer per-slice microbatches; tensor-core-aligned head_dim")


def table() -> str:
    lines = [
        "| arch | shape | mesh | chips | compute | memory | collective | "
        "dominant | useful flops | bytes/device |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    notes = []
    for a in ASSIGNED_ARCHS:
        for s in INPUT_SHAPES:
            for m in ("single", "multi"):
                r = load(a, s.name, m)
                if r is None:
                    lines.append(f"| {a} | {s.name} | {m} | - | MISSING |"
                                 " | | | | |")
                    continue
                if r.get("status") == "skipped":
                    lines.append(f"| {a} | {s.name} | {m} | - | SKIPPED |"
                                 f" | | | | {r['reason'][:60]} |")
                    continue
                if r.get("status") != "ok":
                    lines.append(f"| {a} | {s.name} | {m} | - | "
                                 f"{r['status'].upper()} | | | | | |")
                    continue
                rf = r["roofline"]
                bpd = r["memory"]["bytes_per_device"]
                swa = " (SWA variant)" if r.get("swa_variant") else ""
                lines.append(
                    f"| {a}{swa} | {s.name} | {m} | {r['chips']} | "
                    f"{fmt_s(rf['compute_s'])} | {fmt_s(rf['memory_s'])} | "
                    f"{fmt_s(rf['collective_s'])} | **{rf['dominant']}** | "
                    f"{rf['useful_flop_ratio']:.3f} | {bpd / 1e9:.2f} GB |")
                if m == "single":
                    notes.append(f"- **{a} x {s.name}**: {one_liner(r)}")
    return "\n".join(lines) + "\n\n### Per-pair bottleneck notes " \
        "(single-pod)\n" + "\n".join(notes)


def main() -> None:
    print(table())


if __name__ == "__main__":
    main()
