"""The port's package boundary and entry points, on the CPU: it imports no
JAX and nothing of ``repro``, its engine refuses to guess a device, its
serve command runs, and its analytic replica model agrees with the JAX
package's under one explicit ``GpuSpec``."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.serving import engine as pt_engine


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SRC = Path(__file__).resolve().parents[1] / "src"


def _run(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=timeout)


def test_port_imports_no_jax_and_nothing_of_repro():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro') or m.startswith('jax')]\n"
        "print(len(names), bad)\n"
        "print(' '.join(names))\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    proc = _run("-c", code)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    names = proc.stdout.splitlines()[1].split()
    for mod in ("core.barrier", "core.checkpoint", "core.migration",
                "kernels.checksum.fingerprint", "kernels.checksum.ops",
                "kernels.checksum.ref", "utils.hashing", "utils.tree",
                "core.sla", "scheduler.executor", "scheduler.policy",
                "scheduler.node_map", "launch.real_fleet", "core.buffers",
                "core.device_proxy", "core.splicing", "core.validation",
                "models.moe", "scheduler.simulator", "scheduler.serving",
                "scheduler.scenarios"):
        assert f"repro_torch.{mod}" in names


def test_engine_without_device_raises_where_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt_engine.ServingEngine(get_smoke_config("olmo-1b"))


@pytest.mark.parametrize("arch", ["whisper-base", "llama-3.2-vision-11b"])
def test_engine_serves_the_audio_and_vlm_families(arch):
    """The engine draws the frame or patch embeddings itself and generates
    on the CPU: the same tokens from the same seeds, of the vocabulary."""
    cfg = get_smoke_config(arch)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 12))
    out = [pt_engine.ServingEngine(cfg, seed=3, device="cpu").generate(
        prompts, max_new_tokens=4) for _ in range(2)]
    assert out[0].dtype == torch.int32 and out[0].shape == (2, 4)
    assert torch.equal(out[0], out[1])
    assert 0 <= int(out[0].min()) and int(out[0].max()) < cfg.vocab_size


def test_serve_cli_runs_plan_and_smoke_on_cpu():
    proc = _run("-m", "repro_torch.launch.serve", "--device", "cpu",
                "--decode-tokens", "4")
    assert proc.returncode == 0, proc.stderr
    assert "plan[olmo-1b]" in proc.stdout
    assert "smoke[olmo-1b]" in proc.stdout and "ran on cpu" in proc.stdout


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-1.2b"])
def test_serve_cli_runs_the_ssm_families_on_cpu(arch):
    proc = _run("-m", "repro_torch.launch.serve", "--arch", arch, "--device",
                "cpu", "--decode-tokens", "4")
    assert proc.returncode == 0, proc.stderr
    assert f"plan[{arch}]" in proc.stdout
    assert f"smoke[{arch}]" in proc.stdout and "ran on cpu" in proc.stdout
    assert "generated token ids (first row):" in proc.stdout


def test_default_gpu_spec_is_the_h100_data_sheet():
    gpu = pt_engine.DEFAULT_GPU
    assert (gpu.hbm_bytes, gpu.hbm_bandwidth, gpu.flops) == (
        80e9, 3.35e12, 989e12)


@pytest.mark.parametrize("arch", ["olmo-1b", "yi-9b", "qwen3-moe-30b-a3b",
                                  "mamba2-130m"])
@pytest.mark.parametrize("slo_ms", [30.0, 200.0])
def test_replica_profile_matches_jax_under_one_gpu_spec(arch, slo_ms):
    spec = dict(name="probe", hbm_bytes=int(40e9), hbm_bandwidth=2.0e12,
                flops=300e12, mfu=0.35, step_overhead_seconds=5e-4)
    ours = pt_engine.ReplicaProfile.from_config(
        get_config(arch), slo_ms, gpu=pt_engine.GpuSpec(**spec))
    want = jax_engine.ReplicaProfile.from_config(
        jax_get_config(arch), slo_ms, gpu=jax_engine.GpuSpec(**spec))
    assert dataclasses.asdict(ours) == dataclasses.asdict(want)
