"""The harness: discovery by name, the metric arithmetic, the command's
refusals and its imports, and (on a card) a whole run at a small size."""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types
from typing import Optional, Tuple

import pytest
import torch
import torch.nn.functional as F

from _smoke import ROOT, cell
from bench import costs, harness, trace as trace_lib, weights


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def test_new_cell_config_and_metric_are_found_from_files(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as files and entries are found by name; no file is edited."""
    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    conf = json.loads((root / "bench/configs/olmo-1b.json").read_text())
    conf["name"] = conf["model"]["name"] = "olmo-tiny"
    conf["model"].update(num_layers=2, d_model=64, d_ff=128, vocab_size=256)
    (root / "bench/configs/olmo-tiny.json").write_text(json.dumps(conf))
    (root / "bench/traffic/tiny-mix.json").write_text(json.dumps(
        {"seq_len": 32, "global_batch": 2, "world": 2, "physical": 1,
         "zipf_exponent": 1.2}))
    job = json.loads((root / "bench/workloads/olmo1b-train-s1.json")
                     .read_text())
    (root / "bench/workloads/tiny-cell.json").write_text(json.dumps(job))
    (root / "bench/metrics/tiny_steps.train.py").write_text(
        "def read(run):\n    return float(len(run.step_s))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "olmo-tiny", "source": "test",
                            "file": "bench/configs/olmo-tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-cell", "config": "olmo-tiny",
                              "traffic": "tiny-mix", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "tiny_steps.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "train_tokens_per_s",
                              "workloads": ["tiny-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    c = harness.load_cell("tiny-cell", root)
    assert c.config["model"]["d_model"] == 64
    assert (c.splice, c.rows_per_slice, c.tokens_per_step) == (2, 1, 64)
    assert c.traffic["zipf_exponent"] == 1.2
    assert [m["name"] for m in c.per_layer] == ["tiny_steps.train"]
    assert {m["name"] for m in c.end_to_end} == {
        "train_tokens_per_s", "train_peak_mem_gib", "setup_s"}
    read = harness.metric_reader("tiny_steps.train", root)
    assert read(harness.Run(c, [1.0, 2.0], None)) == 2.0
    assert all(p.read_bytes() == b for p, b in before.items())
    # the cells of the repository each find their own metrics
    granite = harness.load_cell("granite-moe-train-s1", root)
    assert "moe_dispatch_ms.train" in [m["name"] for m in granite.per_layer]
    assert "moe_dispatch_ms.train" not in [
        m["name"] for m in harness.load_cell("olmo1b-train-s1").per_layer]


@pytest.mark.parametrize("name", ["olmo1b-train-s1", "granite-moe-train-s1"])
def test_drawn_state_has_the_ports_layout(name):
    """The state the benchmark draws is the port's train state leaf for
    leaf (path, shape, dtype), at full size: the port's on ``meta``, the
    benchmark's layout from the configuration's file."""
    from repro_torch.training.state import init_train_state

    c = harness.load_cell(name)
    cfg, tcfg = harness.program_config(c)
    state = init_train_state(cfg, tcfg, device="meta")
    theirs = {k: tuple(v.shape) for k, v in weights.leaves(state["params"])}
    ours = dict(weights.leaves(weights.layout(c.config)))
    assert theirs == ours
    assert {v.dtype for _, v in weights.leaves(state)} == {torch.float32,
                                                           torch.int32}
    # the port's count leaves the norms' scales out
    assert sum(math.prod(s) for k, s in ours.items()
               if not k.endswith("scale")) == cfg.param_count()


# The leaves of the existing configurations at the CPU tests' sizes
# (``_smoke.cell``), seed 3000000019, as the harness drew them before the
# layouts and draws moved into the family modules: the first 16 hex digits
# of the sha256 of each leaf's f32 bytes, and its first value.
SEED = 3000000019
PINNED = {
    ("olmo1b-train-s1", "embed"): ("9e410888c9bbc63d", -0.007070150226354599),
    ("olmo1b-train-s1", "blocks.attn.wo"): ("186a7defb9900cfe",
                                            -0.0001521379017503932),
    ("olmo1b-train-s1", "blocks.mlp.wo"): ("16700c523d58f92c",
                                           0.029428739100694656),
    ("granite-moe-train-s1", "embed"): ("9e410888c9bbc63d",
                                        -0.007070150226354599),
    ("granite-moe-train-s1", "blocks.attn.wo"): ("186a7defb9900cfe",
                                                 -0.0001521379017503932),
    ("granite-moe-train-s1", "blocks.moe.wo"): ("3cbb2f797daeefd6",
                                                0.00926192943006754),
    ("granite-moe-train-s1", "blocks.moe.router"): ("30c0ff589354d52d",
                                                    0.0009015125688165426),
}
# the whole train state, each leaf's path and bytes in the tree's order
PINNED_STATE = {"olmo1b-train-s1": "1799be5fd59c977a",
                "granite-moe-train-s1": "3c9c0a67772b0beb"}


def _digest(w: torch.Tensor) -> str:
    return hashlib.sha256(w.numpy().tobytes()).hexdigest()[:16]


@pytest.mark.parametrize("name,path", list(PINNED),
                         ids=[f"{n}-{p}" for n, p in PINNED])
def test_draws_are_the_recorded_ones(name, path):
    """A leaf of an existing configuration, drawn alone, is bit for bit
    what the harness drew before the family modules held the layouts."""
    c = cell(name)
    w = weights.initial(c.config, SEED, "cpu")(path)
    digest, first = PINNED[(name, path)]
    assert w.flatten()[0].item() == first
    assert _digest(w) == digest


@pytest.mark.parametrize("name", list(PINNED_STATE))
def test_drawn_state_is_the_recorded_one(name):
    state = weights.train_state(cell(name).config, SEED, "cpu")
    h = hashlib.sha256()
    for path, leaf in weights.leaves(state):
        h.update(path.encode())
        h.update(leaf.numpy().tobytes())
    assert h.hexdigest()[:16] == PINNED_STATE[name]


# ------------------------------------------------- a family added as files
def _ssm_family() -> types.ModuleType:
    """The family module of the port's ``ssm`` family (Mamba2 blocks), as
    a new family would add it under ``reference/``: its layout, Mamba2's
    published initialisation of ``A_log``, ``dt_bias`` and ``D``, and its
    step FLOPs.  It holds no ``train``: this test runs no reference."""
    def layout(model):
        d, v, n, s = (model["d_model"], model["vocab_size"],
                      model["num_layers"], model["ssm"])
        d_in = s["expand"] * d
        heads, state = d_in // s["head_dim"], s["state_dim"]
        conv = d_in + 2 * state
        return {"embed": (v, d), "final_norm": {"scale": (d,)},
                "blocks": {"ln1": {"scale": (n, d)}, "ssm": {
                    "in_proj": (n, d, 2 * d_in + 2 * state + heads),
                    "conv_w": (n, s["conv_width"], conv),
                    "conv_b": (n, conv), "A_log": (n, heads),
                    "D": (n, heads), "dt_bias": (n, heads),
                    "norm_scale": (n, d_in), "out_proj": (n, d_in, d)}}}

    def step_flops(model, tokens_per_row, rows):
        """6 N T for the projections and the tied head, and 3x the SSD's
        intra-chunk products (C B^T over the chunk's pairs, then its
        product with x) in every layer."""
        d, s = model["d_model"], model["ssm"]
        d_in = s["expand"] * d
        heads = d_in // s["head_dim"]
        proj = d * (2 * d_in + 2 * s["state_dim"] + heads) + d_in * d
        n = model["num_layers"] * proj + d * model["vocab_size"]
        t = tokens_per_row * rows
        ssd = 2 * t * s["chunk_size"] * heads * (s["state_dim"]
                                                  + s["head_dim"])
        return 6 * n * t + 3 * model["num_layers"] * ssd

    module = types.ModuleType("bench.reference.tiny_ssm")
    module.layout, module.step_flops = layout, step_flops
    module.DRAWS = {"A_log": ("log_of_uniform", 1.0, 16.0),
                    "dt_bias": ("dt_bias", 1e-3, 1e-1),
                    "D": ("ones",), "conv_b": ("zeros",)}
    return module


def test_a_new_family_joins_as_files(tmp_path, monkeypatch):
    """A configuration of a family the harness has never drawn (the
    port's ``ssm``) joins with a family module, a config, a traffic mix, a
    workload and entries: its sub-config is built, its state drawn in the
    port's layout with Mamba2's published ranges, one step runs to a
    finite loss, and ``step_mfu.train`` reads the module's FLOPs.  No file
    that was there changes."""
    from repro_torch.configs.base import SSMConfig
    from repro_torch.training.state import init_train_state

    root = _copy(tmp_path)
    before = {p: p.read_bytes() for p in (root / "bench").rglob("*")
              if p.is_file()}
    family = _ssm_family()
    monkeypatch.setitem(sys.modules, family.__name__, family)
    model = {"name": "tiny-ssm", "arch_type": "ssm", "num_layers": 2,
             "d_model": 64, "num_heads": 0, "num_kv_heads": 0, "d_ff": 0,
             "vocab_size": 256, "norm": "rmsnorm", "tie_embeddings": True,
             "dtype": "bfloat16",
             "ssm": {"state_dim": 16, "head_dim": 16, "expand": 2,
                     "chunk_size": 8, "conv_width": 4}}
    (root / "bench/configs/tiny-ssm.json").write_text(json.dumps(
        {"name": "tiny-ssm", "model": model,
         "reference": {"module": "tiny_ssm"}}))
    (root / "bench/traffic/tiny-ssm-mix.json").write_text(json.dumps(
        {"seq_len": 32, "global_batch": 2, "world": 2, "physical": 1,
         "zipf_exponent": 1.0}))
    job = json.loads((root / "bench/workloads/olmo1b-train-s1.json")
                     .read_text())
    (root / "bench/workloads/tiny-ssm-cell.json").write_text(json.dumps(
        dict(job, check_steps=1)))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny-ssm", "source": "test",
                            "file": "bench/configs/tiny-ssm.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-ssm-cell", "config": "tiny-ssm",
                              "traffic": "tiny-ssm-mix", "chips": 1,
                              "why": "test"})
    next(m for m in spec["per_layer"] if m["name"] == "step_mfu.train")[
        "workloads"].append("tiny-ssm-cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    c = harness.load_cell("tiny-ssm-cell", root)
    cfg, tcfg = harness.program_config(c)
    assert isinstance(cfg.ssm, SSMConfig) and cfg.ssm.chunk_size == 8
    port = init_train_state(cfg, tcfg, device="meta")
    state = weights.train_state(c.config, SEED, "cpu")
    assert {k: (tuple(v.shape), v.dtype)
            for k, v in weights.leaves(port)} == {
        k: (tuple(v.shape), v.dtype) for k, v in weights.leaves(state)}
    ssm = state["params"]["blocks"]["ssm"]
    a = -torch.exp(ssm["A_log"])
    assert a.min() >= -16 and a.max() <= -1 and a.std() > 0
    dt = F.softplus(ssm["dt_bias"].double())
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 1e-1 * (1 + 1e-5)
    assert dt.std() > 0
    assert torch.equal(ssm["D"], torch.ones_like(ssm["D"]))
    assert torch.equal(ssm["conv_b"], torch.zeros_like(ssm["conv_b"]))
    # one leaf drawn again alone is the state's
    assert torch.equal(weights.initial(c.config, SEED, "cpu")(
        "blocks.ssm.dt_bias"), ssm["dt_bias"])

    rt = harness.build(c, SEED, "cpu")
    prog = harness.first_steps(rt, c, SEED, "cpu")
    assert len(prog["losses"]) == 1 and math.isfinite(prog["losses"][0])
    assert set(prog["change"]) == {k for k, _ in weights.leaves(
        weights.layout(c.config))}

    assert [m["name"] for m in c.per_layer] == ["step_mfu.train"]
    read = harness.metric_reader("step_mfu.train", root)
    flops = family.step_flops(c.config["model"], 32, 2)
    assert read(harness.Run(c, [0.5], None)) == pytest.approx(
        100 * flops / 0.5 / costs.PEAK_BF16_FLOPS)
    assert all(p.read_bytes() == b for p, b in before.items())


_RULES = {
    "ones": (("ones",), lambda w: torch.equal(w, torch.ones_like(w))),
    "zeros": (("zeros",), lambda w: torch.equal(w, torch.zeros_like(w))),
    "constant": (("constant", 0.5),
                 lambda w: torch.equal(w, torch.full_like(w, 0.5))),
    "normal": (("normal", 0.1),
               lambda w: abs(float(w.std()) - 0.1) < 0.005
               and abs(float(w.mean())) < 0.005),
    "uniform": (("uniform", 2.0, 3.0),
                lambda w: 2 <= w.min() and w.max() <= 3
                and abs(float(w.mean()) - 2.5) < 0.01),
    "log_of_uniform": (("log_of_uniform", 1.0, 16.0),
                       lambda w: 0 <= w.min() and w.max() <= math.log(16)
                       and abs(float(w.exp().mean()) - 8.5) < 0.1),
    "dt_bias": (("dt_bias", 1e-3, 1e-1),
                lambda w: 1e-3 * (1 - 1e-5) <= F.softplus(w.double()).min()
                and F.softplus(w.double()).max() <= 1e-1 * (1 + 1e-5)),
}


@pytest.mark.parametrize("rule", sorted(_RULES))
def test_each_rule_of_the_menu_draws_what_it_says(rule):
    """Each rule a family's ``DRAWS`` may name, on a leaf of 10,000: its
    values as the rule states them, drawn again alike from the seed, and
    the leaf's default rule left to every leaf the family does not name."""
    assert set(_RULES) == set(weights.MENU)
    spec, holds = _RULES[rule]
    rules = {"w": spec}
    w = weights.draw("blocks.x.w", (100, 100), SEED, "cpu", rules)
    assert w.dtype == torch.float32 and holds(w)
    assert torch.equal(w, weights.draw("blocks.x.w", (100, 100), SEED,
                                       "cpu", rules))
    assert torch.equal(weights.draw("blocks.x.v", (100, 100), SEED, "cpu",
                                    rules),
                       weights.draw("blocks.x.v", (100, 100), SEED, "cpu",
                                    {}))


@dataclasses.dataclass(frozen=True)
class _Inner:
    width: int = 1


@dataclasses.dataclass(frozen=True)
class _Outer:
    name: str
    kinds: Tuple[str, ...] = ()
    inner: Optional[_Inner] = None
    table: Optional[dict] = None


def test_program_config_builds_fields_from_their_declared_types():
    """Each nested object becomes the dataclass its field declares, each
    array a tuple, and a field the harness has never seen passes through;
    the result is frozen and hashes as the port's configs do."""
    cfg = harness._typed(_Outer, {"name": "x", "kinds": ["a", "b"],
                                  "inner": {"width": 3},
                                  "table": {"k": [1, 2]}})
    assert cfg == _Outer("x", ("a", "b"), _Inner(3), {"k": (1, 2)})
    hash(dataclasses.replace(cfg, table=None))
    for name in ("olmo1b-train-s1", "granite-moe-train-s1"):
        hash(harness.program_config(harness.load_cell(name))[0])


def test_interval_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 6.5)]
    assert trace_lib.union_length(spans) == pytest.approx(3.5)
    assert trace_lib.gaps(spans) == [(2.0, 1.0), (4.0, 2.0)]


def _trace():
    """A recorded trace of two steps, as ``from_profile`` builds it."""
    device = [("gemm", 0.0, 1.0), ("gemm", 0.9, 1.5), ("Memcpy HtoD", 1.5,
                                                          1.6),
              ("swa_flash_bf16_kernel", 2.0, 2.2), ("ce_bf16_kernel", 2.5,
                                                    3.0)]
    host = [("ElasticRuntime", -0.1, 3.2), ("aten::item", 1.6, 2.0),
            ("repro_torch::swa_flash", 1.8, 2.1)]
    ops = {"_SwaAttentionBackward": trace_lib.OpTime(32, 2.0, 0.0),
           "repro_torch::swa_flash": trace_lib.OpTime(64, 0.1, 0.1),
           "repro_torch::fused_ce_stats": trace_lib.OpTime(2, 0.02, 0.0),
           "aten::index_add_": trace_lib.OpTime(10, 0.3, 0.2),
           "aten::index_select": trace_lib.OpTime(10, 0.05, 0.05)}
    return trace_lib.Trace(2, 4.0, device, host, ops)


def test_trace_summary():
    tr = _trace()
    assert tr.busy_s == pytest.approx(2.3)
    assert tr.kernels == 4
    assert tr.device_ops()[0] == ["gemm", pytest.approx(1.6)]
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::item"] == pytest.approx(0.4)      # 1.6 to 2.0
    assert gaps["ElasticRuntime"] == pytest.approx(0.3)  # 2.2 to 2.5


def test_metric_readers_against_hand_worked_shapes():
    """Each reader on the recorded trace, against numbers worked out by
    hand from olmo-1b's shapes (B 4, S 4096, 16 heads of 128, d 2048,
    V 50304) and the H100's peaks."""
    c = harness.load_cell("olmo1b-train-s1")
    run = harness.Run(c, [1.5, 1.6, 1.7], _trace(), 4.8)

    def read(name):
        return harness.metric_reader(name)(run)

    pairs = 4096 * 4097 // 2
    attn_fwd = 4 * 128 * pairs * 4 * 16
    flops = 6 * 1_176_764_416 * 16384 + 16 * 3 * attn_fwd
    assert read("step_mfu.train") == pytest.approx(
        100 * flops / 1.6 / 989e12)
    bwd = max(8 * 128 * pairs * 4 * 16 / 989e12,
              7 * 4 * 4096 * 16 * 128 * 2 / 3.35e12)
    assert read("attn_bwd_roofline.train") == pytest.approx(
        100 * 32 * bwd / 2.0)
    fwd = max(attn_fwd / 989e12, 4 * 4 * 4096 * 16 * 128 * 2 / 3.35e12)
    assert read("swa_flash_roofline.train") == pytest.approx(
        100 * 64 * fwd / 0.1)
    ce = 2 * 16384 * 2048 * 50304 / 989e12
    assert ce > (2 * (16384 * 2048 + 2048 * 50304) + 12 * 16384) / 3.35e12
    assert read("fused_ce_roofline.train") == pytest.approx(
        100 * 2 * ce / 0.02)
    assert read("moe_dispatch_ms.train") == pytest.approx(1e3 * 0.25 / 2)
    # busy 2.3 s over the trace's 2 steps, against 4.8 s over the
    # window's 3
    assert read("device_idle_share.train") == pytest.approx(
        100 * (1 - 1.15 / 1.6))
    assert read("kernels_per_step.train") == 2.0
    # a reader that finds nothing to read returns nothing
    empty = harness.Run(c, [], trace_lib.Trace(1, 1.0, [], [], {}))
    for m in c.per_layer:
        assert harness.metric_reader(m["name"])(empty) is None


def test_step_flops_of_granite():
    model = harness.load_cell("granite-moe-train-s1").config["model"]
    n = 32 * (2 * 1536 * 1536 + 2 * 1536 * 512 + 1536 * 40
              + 3 * 1536 * 512 * 8) + 1536 * 49155
    assert costs.matmul_params(model) == n
    attn = 3 * 4 * 64 * (4096 * 4097 // 2) * 4 * 24
    assert costs.step_flops(model, 4096, 4) == 6 * n * 16384 + 32 * attn


def test_step_flops_of_olmo():
    model = harness.load_cell("olmo1b-train-s1").config["model"]
    n = 16 * (4 * 2048 * 2048 + 3 * 2048 * 8192) + 2048 * 50304
    assert costs.matmul_params(model) == n == 1_176_764_416
    attn = 3 * 4 * 128 * (4096 * 4097 // 2) * 4 * 16
    flops = costs.step_flops(model, 4096, 4)
    assert flops == 6 * n * 16384 + 16 * attn == 128_878_009_909_248
    assert isinstance(flops, int)


def test_tokens_per_step_over_the_window():
    """The window's rate is every token of its steps over its length."""
    c = cell("olmo1b-train-s1")
    result = harness.run(c, 7, 0.3, False, "cpu", time.perf_counter())
    m = result["metrics"]
    steps = result["attempted"]
    assert steps >= 1
    assert m["train_tokens_per_s"]["value"] > 0
    assert set(m) == {"train_tokens_per_s", "train_peak_mem_gib", "setup_s"}
    assert list(result)[-1] == "checks"


def _python(code):
    env = dict(os.environ, PYTHONPATH="")
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run of the harness (at a small size, on the CPU) and its
    reference leave no module whose top-level name is jax, jaxlib, flax
    or repro (``repro_torch`` is another name)."""
    proc = _python(
        "import sys, time; sys.path[:0] = ['bench/tests']\n"
        "from _smoke import cell\n"
        "from bench import harness\n"
        "harness.run(cell('granite-moe-train-s1'), 3, 0.1, False, 'cpu', "
        "time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(harness.forbidden_loaded())")
    assert proc.returncode == 0, proc.stderr[-2000:]
    names, loaded = proc.stdout.strip().splitlines()[-2:]
    assert "repro_torch" in names
    assert loaded == "[]"


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "olmo1b-train-s1",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's files
    the command exits non-zero and prints no result."""
    root = _copy(tmp_path)
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "olmo1b-train-s1",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_small_run_on_the_card():
    """On a card: a traced run at a small size is correct and reads every
    per-layer metric of its cell from the device's trace."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for name in ("olmo1b-train-s1", "granite-moe-train-s1"):
        c = cell(name)
        result = harness.run(c, 41, 0.5, True, "cuda", time.perf_counter())
        assert result["correct"], result["checks"]
        assert result["device"]["busy_s"] > 0
        assert set(result["metrics"]) == {m["name"] for m in c.per_layer}
