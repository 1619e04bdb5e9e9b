"""Cells of the benchmark cut to a size the CPU tests can run: the same
files and code paths, with a few small widths in place of the published
ones and 32-token sequences."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [p for p in (str(ROOT / "src"), str(ROOT)) if p not in sys.path]

from bench import harness  # noqa: E402

# limits at this size, from the program's and the control's readings on
# seeds 21-26 (program at most 1.43e-4 nats, 1.35e-3 (dense) by the worst
# leaf's step-1 gradient before the clip, and 3.7e-4 (dense) or 1.5e-3
# (MoE) by the worst leaf's change; the fp8 control at least 2.9e-4 and
# 1.6e-3 (dense) or 6.9e-4 nats (MoE), and 6.6e-3 (dense) by the
# gradient.  The MoE's step-1 gradient at this size reads up to 9.8e-3
# against the control's 8.9e-3, and no embedding gap separates: neither
# has a limit here)
LIMITS = {False: {"loss_gap": 3e-4, "grad1_gap": 4e-3, "change_gap": 8e-4},
          True: {"loss_gap": 3e-4, "change_gap": 3e-3}}
CELLS = ("olmo1b-train-s1", "granite-moe-train-s1", "olmo1b-train-s4")


def cell(name: str, root: Path = ROOT, dtype: str = "bfloat16"):
    c = harness.load_cell(name, root)
    model = dict(c.config["model"])
    moe = bool(model.get("moe"))
    model.update(num_layers=2, d_model=64, num_heads=4,
                 num_kv_heads=2 if moe else 4, d_ff=32 if moe else 128,
                 vocab_size=256, dtype=dtype)
    if moe:
        model["moe"] = dict(model["moe"], num_experts=4, top_k=2)
    c.config = dict(c.config, model=model)
    c.traffic = dict(c.traffic, seq_len=32)
    c.job = dict(c.job, limits=LIMITS[moe])
    return c
