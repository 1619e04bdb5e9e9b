"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Prints the checks of ``correct`` last on standard error and one JSON
line last on standard output: the end-to-end metrics with ``--trace 0``,
the per-layer ones with ``--trace 1``.  Exits non-zero, with no result,
where there is no card or too few, or where the run loaded JAX or the JAX
package.  ``bench/README.md`` says how a cell is added.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of a build or a compile stays inside the checkout, at a
    # fixed path, so the second run of a cell finds it
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from bench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("[bench] no CUDA card: nothing measured", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"[bench] {args.workload} needs {cell.chips} cards, this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_START)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"[bench] the run loaded {loaded}: the port's benchmark runs "
              f"without JAX and the JAX package", file=sys.stderr)
        return 3
    harness.emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
