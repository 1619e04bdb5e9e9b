"""The reference against the port's CPU path, the control, and the
planted faults that ``correct`` has to catch, at a size the CPU holds."""
from __future__ import annotations

import copy
import time

import pytest
import torch

from _smoke import CELLS, cell
from bench import harness, judge


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def readings(c, seed, **kw):
    rt = harness.build(c, seed, "cpu")
    prog = harness.first_steps(rt, c, seed, "cpu")
    return prog, harness.reference_readings(c, seed, "cpu", **kw)


@pytest.mark.parametrize("name", CELLS)
def test_reference_equals_port_in_f32(name):
    """At f32 the port's step and the reference agree to f32 rounding:
    the same embedding, norms, attention, MLP or router with its capacity
    and drops, aux loss, CE, slice sum and AdamW."""
    c = cell(name, dtype="float32")
    prog, ref = readings(c, 5)
    numbers = judge.gaps(prog, ref)
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad1_gap"] < 1e-5
    assert numbers["embed_grad1_gap"] < 1e-5
    assert numbers["change_gap"] < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_holds(name):
    """The reference in fp8 in the program's place fails a limit on each
    of three seeds; the program's bf16 path holds them all."""
    c = cell(name)
    limits = c.job["limits"]
    for seed in (21, 22, 23):
        prog, ref = readings(c, seed)
        assert judge.holds(judge.gaps(prog, ref), limits)
        control = harness.reference_readings(c, seed, "cpu", matmul="fp8")
        assert not judge.holds(judge.gaps(control, ref), limits)


def _unchanged(monkeypatch):
    """Each step returns the state it was given, as it was."""
    from repro_torch.core import elastic

    real = elastic.build_train_step

    def build(*args, **kwargs):
        step = real(*args, **kwargs)

        def broken(state, batch, flags=None):
            return state, step(copy.deepcopy(state), batch, flags)[1]
        return broken
    monkeypatch.setattr(elastic, "build_train_step", build)


def _half(monkeypatch):
    """Each step's gradient is the mean over the first half of its batch."""
    from repro_torch.training import step

    real = step.loss_and_grads

    def broken(params, batch, cfg, tcfg, splice=1):
        half = batch["tokens"].shape[0] // 2
        return real(params, {k: v[:half] for k, v in batch.items()}, cfg,
                    tcfg, max(1, splice // 2))
    monkeypatch.setattr(step, "loss_and_grads", broken)


def _last_slice(monkeypatch):
    """The slices' gradient sum left out: the last slice's alone."""
    from repro_torch.training import step

    real = step.loss_and_grads

    def broken(params, batch, cfg, tcfg, splice=1):
        per = batch["tokens"].shape[0] // splice
        return real(params, {k: v[-per:] for k, v in batch.items()}, cfg,
                    tcfg, 1)
    monkeypatch.setattr(step, "loss_and_grads", broken)


def _one_leaf_scaled(monkeypatch):
    """One leaf's gradient (the attention's output projection) 10% high."""
    from repro_torch.training import step

    real = step.loss_and_grads

    def broken(*args, **kwargs):
        loss, grads = real(*args, **kwargs)
        grads["blocks"]["attn"]["wo"].mul_(1.1)
        return loss, grads
    monkeypatch.setattr(step, "loss_and_grads", broken)


FAULTS = [(name, fault) for name in CELLS
          for fault in (_unchanged, _half)] + [
    ("olmo1b-train-s4", _last_slice),
    ("olmo1b-train-s1", _one_leaf_scaled),
    ("olmo1b-train-s4", _one_leaf_scaled)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_a_run_with_a_broken_step_is_not_correct(name, fault, monkeypatch):
    """A whole run on the CPU, with the timed path broken underneath,
    comes out not correct; the same run unbroken comes out correct."""
    c = cell(name)
    assert harness.run(c, 31, 0.2, False, "cpu",
                       time.perf_counter())["correct"]
    fault(monkeypatch)
    result = harness.run(c, 31, 0.2, False, "cpu", time.perf_counter())
    assert not result["correct"]
    assert list(result)[-1] == "checks"
