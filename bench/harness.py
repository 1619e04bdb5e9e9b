"""One run of one cell: set-up, the measured window, the traced
sub-window, and the comparison that decides ``correct``.

Everything that belongs to a cell is found by name from
``BENCHMARK.json``: the configuration's file (``configs``), the traffic
file ``bench/traffic/<traffic>.json``, the job's file
``bench/workloads/<cell>.json`` (optimizer, donation, the steps compared,
the steps traced, the limits of ``correct``) and each per-layer metric's
reader ``bench/metrics/<metric>.py``.  A new cell, configuration or metric
is new files and entries; nothing here names one.

The program under test is ``repro_torch``'s elastic training job:
``core/elastic.py::ElasticRuntime.run_steps`` driving the spliced step of
``training/step.py``.  The benchmark makes its state (``weights.py``, in
the layout of the configuration's family module in ``reference/``) and
its batches (``traffic.py``) and hands them in.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
import typing
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from bench import judge, reference, trace as trace_lib, traffic, weights

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
GIB = 1 << 30


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration's file
    traffic: dict         # the traffic file
    job: dict             # the cell's workload file
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def splice(self) -> int:
        return self.traffic["world"] // self.traffic["physical"]

    @property
    def rows_per_slice(self) -> int:
        return self.traffic["global_batch"] // self.splice

    @property
    def tokens_per_step(self) -> int:
        return self.traffic["global_batch"] * self.traffic["seq_len"]


def _applies(metric: dict, cell: str) -> bool:
    """A metric is the cell's where its ``workloads`` list the cell, and
    every cell's without the key (a per-layer reader that finds nothing
    to read in a cell returns nothing there)."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json`` with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in spec['workloads']]}")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    bench = root / "bench"
    e2e = [m for m in spec["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in spec["per_layer"] if _applies(m, name)]
    return Cell(name=name, chips=entry["chips"],
                config=json.loads((root / conf["file"]).read_text()),
                traffic=traffic.load(bench / "traffic"
                                     / f"{entry['traffic']}.json"),
                job=json.loads((bench / "workloads"
                                / f"{name}.json").read_text()),
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run)`` of ``bench/metrics/<name>.py``."""
    path = root / "bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


# ------------------------------------------------------------- the program
def _typed(cls, values: dict):
    """The dataclass ``cls`` from a JSON object: each field's value as its
    declared type takes it, a nested object as the dataclass the field
    declares (a plain dict where it declares none), every array as a
    tuple."""
    hints = typing.get_type_hints(cls)
    return cls(**{k: _value(hints.get(k), v) for k, v in values.items()})


def _value(hint, value):
    if isinstance(value, list):
        return tuple(_value(None, x) for x in value)
    if isinstance(value, dict):
        cls = next((t for t in (hint, *typing.get_args(hint))
                    if dataclasses.is_dataclass(t)), None)
        if cls is None:
            return {k: _value(None, v) for k, v in value.items()}
        return _typed(cls, value)
    return value


def program_config(cell: Cell):
    """The port's ``ModelConfig`` (with its sub-configs) and
    ``TrainConfig`` of the cell."""
    from repro_torch.configs.base import ModelConfig, TrainConfig

    job = cell.job
    return (_typed(ModelConfig, cell.config["model"]),
            TrainConfig(**job["optim"], remat=job["remat"],
                        remat_policy=job["remat_policy"]))


def _flat(tree) -> Dict[str, torch.Tensor]:
    return dict(weights.leaves(tree))


def build(cell: Cell, seed: int, device):
    """The job: ``ElasticRuntime`` on the benchmark's state and batches."""
    from repro_torch.core.elastic import ElasticRuntime

    cfg, tcfg = program_config(cell)
    state = weights.train_state(cell.config, seed, device)
    t = cell.traffic
    rt = ElasticRuntime(cfg, tcfg, t["world"], t["physical"],
                        t["global_batch"], t["seq_len"], state=state,
                        device=device, donate=cell.job["donate"])
    rt.pipeline = traffic.Feed(traffic.ZipfTokens(t, cfg.vocab_size, seed,
                                                  device))
    return rt


def first_steps(rt, cell: Cell, seed: int, device) -> dict:
    """The job's first ``check_steps`` steps, through the window's own
    call and feed, and what they produced: each step's loss, each leaf's
    step-1 gradient before the global clip (its first moment after the
    step, over 1 - beta1, over the clip's factor from the step's reported
    pre-clip norm), and each leaf's change over the steps, against the
    drawn weights."""
    optim = cell.job["optim"]
    out = {"losses": [], "step_wall": []}
    for i in range(cell.job["check_steps"]):
        t0 = time.perf_counter()
        rec = rt.run_steps(1)[0]
        out["losses"].append(rec["loss"])
        out["step_wall"].append(time.perf_counter() - t0)
        if i == 0:
            clip = min(1.0, optim["grad_clip"] / max(rec["grad_norm"], 1e-9))
            out["grad1"] = {
                k: float(torch.linalg.vector_norm(m))
                / (1 - optim["beta1"]) / clip
                for k, m in _flat(rt.state["opt"]["m"]).items()}
    init = weights.initial(cell.config, seed, device)
    with torch.no_grad():
        out["change"] = {
            k: float(torch.linalg.vector_norm(p - init(k)))
            for k, p in _flat(rt.state["params"]).items()}
    return out


# ----------------------------------------------------------- the reference
def reference_readings(cell: Cell, seed: int, device, matmul: str = "f32",
                       rows: Optional[slice] = None,
                       splice: Optional[int] = None) -> dict:
    """The reference's readings of the cell's first steps (``rows`` and
    ``splice`` plant a fault: a part of each batch in a step of its
    own)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = cell.config["model"]
    paths = [k for k, _ in weights.leaves(weights.layout(cell.config))]
    tokens = traffic.ZipfTokens(cell.traffic, model["vocab_size"], seed,
                                device)
    batches = [tokens.batch(i) for i in range(cell.job["check_steps"])]
    if rows is not None:
        batches = [(a[rows], b[rows]) for a, b in batches]
    return reference.load(cell.config).train(
        model, cell.config["reference"], cell.job["optim"],
        weights.initial(cell.config, seed, device), paths,
        batches, splice or cell.splice, matmul)


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


# ----------------------------------------------------------------- the run
@dataclasses.dataclass
class Run:
    """What a per-layer metric's reader sees."""
    cell: Cell
    step_s: List[float]            # each window step's device time
    trace: Optional[trace_lib.Trace]
    window_s: float = 0.0          # the measured window's host time


def _card() -> dict:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30).stdout.strip()
        name, limit = (x.strip() for x in out.split(","))
        return {"smi_name": name, "power_limit_w": float(limit)}
    except (OSError, ValueError, subprocess.SubprocessError):
        return {"smi_name": None, "power_limit_w": None}


def _timed_step(rt, device) -> float:
    """One step of the job, and its device time (CUDA events)."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        rt.run_steps(1)
        return time.perf_counter() - t0
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    rt.run_steps(1)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float) -> dict:
    """One run: the result line's fields (``checks`` last)."""
    cuda = torch.device(device).type == "cuda"
    torch.set_num_threads(4)
    t_build = time.perf_counter()
    rt = build(cell, seed, device)
    _sync(device)
    t_steps = time.perf_counter()
    prog = first_steps(rt, cell, seed, device)
    _sync(device)
    print(f"[bench] setup: {t_build - t_start!r} s of imports and start-up, "
          f"{t_steps - t_build!r} s to draw the state and build the job, "
          f"{time.perf_counter() - t_steps!r} s for the first "
          f"{cell.job['check_steps']} steps ({prog['step_wall']!r} s) "
          f"and their readings",
          file=sys.stderr, flush=True)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    start_hist = len(rt.history)
    # the window: steps back to back until ``seconds`` have passed
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    step_s = []
    while time.perf_counter() - t0 < seconds:
        step_s.append(_timed_step(rt, device))
    _sync(device)
    window_s = time.perf_counter() - t0
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    losses = [r["loss"] for r in rt.history[start_hist:]]
    tr = None
    if traced:
        tr = _profile(rt, cell, device)
        top = sorted(tr.ops.items(), key=lambda kv: -kv[1].device_s)[:8]
        print(f"[bench] trace: {len(tr.device)} device operations, busy "
              f"{tr.busy_s!r} s of {tr.window_s!r} s; host operators by "
              f"device time: " + ", ".join(
                  f"{k} x{v.count} {v.device_s!r} s" for k, v in top),
              file=sys.stderr, flush=True)
    print(f"[bench] {cell.name} seed {seed}: setup {setup_s!r} s, "
          f"{len(step_s)} steps in {window_s!r} s, step device s "
          f"{step_s!r}, losses {losses!r}", file=sys.stderr, flush=True)
    del rt
    free()

    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, device)
    numbers = judge.gaps(prog, ref)
    print(f"[bench] reference: {time.perf_counter() - t_ref!r} s; program "
          f"losses {prog['losses']!r}, reference {ref['losses']!r}",
          file=sys.stderr, flush=True)
    failed = sum(1 for x in losses if not math.isfinite(x))
    limits = cell.job.get("limits", {})
    correct = judge.holds(numbers, limits) and failed == 0
    card = _card() if cuda else {"smi_name": None, "power_limit_w": None}
    result = {
        "correct": correct, "attempted": len(step_s), "failed": failed,
        "metrics": {},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": 1,
                   "memory_peak_bytes": max(setup_peak, window_peak)},
    }
    if not traced:
        values = {"train_tokens_per_s":
                  len(step_s) * cell.tokens_per_step / window_s,
                  "train_peak_mem_gib": window_peak / GIB,
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    elif cuda:
        the_run = Run(cell, step_s, tr, window_s)
        for m in cell.per_layer:
            value = metric_reader(m["name"])(the_run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["card"] = card
    result["checks"] = {name: {"value": numbers[name],
                               "limit": limits.get(name)}
                        for name in judge.NAMES}
    return result


def _profile(rt, cell: Cell, device) -> Optional[trace_lib.Trace]:
    """The traced sub-window after the measured one: ``trace_steps``
    steps recorded, after one small operation that starts the device's
    tracer up."""
    from torch.profiler import ProfilerActivity, profile

    n = cell.job["trace_steps"]
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        torch.ones(1, device=device).add_(1)
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(n):
            rt.run_steps(1)
        _sync(device)
        window_s = time.perf_counter() - t0
    return trace_lib.from_profile(prof, n, window_s)


def forbidden_loaded() -> List[str]:
    """The modules of JAX or of the JAX package this process holds, by
    whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def emit(result: dict) -> None:
    """The checks on standard error, last, and the result line last on
    standard output."""
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)

