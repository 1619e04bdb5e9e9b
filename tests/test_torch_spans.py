"""The spans of the elastic training step (``repro_torch/utils/spans.py``)
on the CPU, at the smoke sizes of olmo-1b and granite-moe-3b-a800m under
full remat, at splice 1 and 2: each span opens as often a step as its
place in the step says, the profiler records it as a host operator and not
as a user annotation, its name is one that ``spans.py`` lists and a reader
of the benchmark (``bench/metrics/``) reads, and a profiler that records
them leaves the losses and the state as they were, bit for bit.  No JAX.
"""
import ast
import collections
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.utils.spans import NAMES
from repro_torch.utils.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
READERS = ("grad_sum_ms.train", "slice_idle_ms.train",
           "boundary_idle_ms.train", "moe_dispatch_span_ms.train",
           "ssm_mixer_ms.train", "ssm_scan_ms.train")
PREFIXES = ("elastic.", "step.", "moe.", "ssm.")
W, G, S, STEPS = 4, 8, 32, 2
CASES = [(arch, splice) for arch in ("olmo-1b", "granite-moe-3b-a800m")
         for splice in (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(arch, splice, profiled):
    """``STEPS`` steps of the smoke job: (records, state, span events or
    None)."""
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(total_steps=40, warmup_steps=2, learning_rate=1e-3,
                       remat=True, remat_policy="full")
    rt = ElasticRuntime(cfg, tcfg, W, W // splice, G, S, device="cpu")
    if not profiled:
        return rt.run_steps(STEPS), rt.state, None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recs = rt.run_steps(STEPS)
    return recs, rt.state, [e for e in prof.events()
                            if e.name.startswith(PREFIXES)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{a}-splice{s}" for a, s in CASES])
def runs(request, one_thread):
    arch, splice = request.param
    return arch, splice, _run(arch, splice, True), _run(arch, splice, False)


def test_each_span_opens_as_often_as_its_place_in_the_step(runs):
    arch, splice, (_, state, events), _ = runs
    cfg = get_smoke_config(arch)
    count = collections.Counter(e.name for e in events)
    per_step = {name: n / STEPS for name, n in count.items()}
    # one gradient add a stacked leaf, layer and slice, and one hand-over
    # of the sums a step
    stacked = len(tree_leaves(state["params"]["blocks"]))
    want = {"elastic.step": 1, "step.forward": splice,
            "step.backward": splice,
            "step.grad_sum": stacked * cfg.num_layers * splice + 1,
            "step.update": 1}
    if cfg.moe is not None:
        # in the forward and in its recompute during the backward
        want["moe.dispatch"] = want["moe.combine"] = \
            2 * cfg.num_layers * splice
    assert per_step == want


def test_spans_are_host_operators_not_annotations(runs):
    _, _, (_, _, events), _ = runs
    assert events
    for e in events:
        assert e.device_type == torch.autograd.DeviceType.CPU
        assert not e.is_user_annotation, e.name


def test_span_names_are_listed_and_read_by_the_benchmark(runs):
    """The names a run records are ``spans.NAMES`` (the MoE's in the MoE
    model; the Mamba2 mixer's in neither, ``test_torch_granite_hybrid.py``
    counts those), and the readers of the benchmark name each of them."""
    arch, _, (_, _, events), _ = runs
    seen = {e.name for e in events}
    moe = {"moe.dispatch", "moe.combine"}
    ssm = {"ssm.mixer", "ssm.scan"}
    assert seen == (set(NAMES) - ssm if arch.startswith("granite")
                    else set(NAMES) - moe - ssm)
    literals = set()
    for name in READERS:
        tree = ast.parse((ROOT / "bench" / "metrics"
                          / f"{name}.py").read_text())
        literals |= {n.value for n in ast.walk(tree)
                     if isinstance(n, ast.Constant)
                     and isinstance(n.value, str)
                     and n.value.startswith(PREFIXES)}
    assert literals == set(NAMES)


def test_profiler_leaves_losses_and_state_bit_for_bit(runs):
    _, _, (recs, state, _), (recs0, state0, _) = runs
    assert [r["loss"] for r in recs] == [r["loss"] for r in recs0]
    assert [r["grad_norm"] for r in recs] == [r["grad_norm"]
                                              for r in recs0]
    a, b = tree_leaves(state), tree_leaves(state0)
    assert len(a) == len(b)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
