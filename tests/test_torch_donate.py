"""The donated step (JAX's ``donate_argnums`` on the state) against the
functional one, on the CPU at smoke size: ``optim/adamw.py::adamw_update_``
and ``build_train_step(..., donate=True)`` write the state in place and must
give the functional results to the bit.  No JAX here: the functional step
is the one the other parity files hold against JAX (its update on whole
leaves and on slices, ``tests/test_torch_train.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import train_state_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.optim import adamw
from repro_torch.optim.adamw import (adamw_init, adamw_update, adamw_update_,
                                     global_norm)
from repro_torch.training import build_train_step, init_train_state
from repro_torch.utils.tree import tree_leaves, tree_map

TCFG = TrainConfig(total_steps=5, warmup_steps=2, learning_rate=1e-3)
W, G, S = 4, 8, 64


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the smoke steps gain nothing from more, and
    beside other test processes on the same cores torch's spinning
    threads slow them a hundredfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("arch", ["olmo-1b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("physical", [(4, 2), (2, 4)],
                         ids=["splice1to2", "splice2to1"])
def test_trajectory_donated_equals_functional(arch, physical):
    """Five steps from copies of one state, three at one splice factor and
    two at the other after a resize: losses, grad norms, params, m, v,
    count and step equal to the bit (f32 sums in the same order; every
    smoke leaf is one slice of the update, so its gradient norm is
    ``global_norm``'s)."""
    cfg = get_smoke_config(arch)
    state = init_train_state(cfg, TCFG, device="cpu")
    runs = {}
    for donate in (False, True):
        rt = ElasticRuntime(cfg, TCFG, W, physical[0], G, S,
                            state=tree_map(torch.clone, state),
                            device="cpu", donate=donate)
        hist = rt.run_steps(3)
        rt.resize(physical[1])
        hist += rt.run_steps(2)
        runs[donate] = ([(h["loss"], h["grad_norm"], h["splice"])
                         for h in hist], train_state_to_numpy(rt.state))
    assert [h[2] for h in runs[True][0]] == \
        [W // physical[0]] * 3 + [W // physical[1]] * 2
    assert runs[True][0] == runs[False][0]
    assert _leaves_equal(runs[True][1], runs[False][1])


def test_step_consumes_the_state():
    """The donated step returns the dict it was given, its tensors written
    in place; the functional step leaves its input as it was."""
    cfg = get_smoke_config("olmo-1b")
    state = init_train_state(cfg, TCFG, device="cpu")
    before = train_state_to_numpy(tree_map(torch.clone, state))
    tok = torch.randint(0, cfg.vocab_size, (G, S),
                        generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tok, "labels": tok}
    new, _ = build_train_step(cfg, TCFG)(state, batch)
    assert _leaves_equal(train_state_to_numpy(state), before)
    ptr = state["params"]["embed"].data_ptr()
    out, _ = build_train_step(cfg, TCFG, donate=True)(state, batch)
    assert out is state and out["params"]["embed"].data_ptr() == ptr
    assert int(out["step"]) == 1
    assert _leaves_equal(train_state_to_numpy(out), train_state_to_numpy(new))


@pytest.mark.parametrize("grad_scale", [1e-3, 1.0],
                         ids=["unclipped", "clipped"])
def test_update_in_slices(monkeypatch, grad_scale):
    """Leaves cut into several axis-0 slices (``UPDATE_CHUNK`` of 100
    elements), the clip off (the norm under ``grad_clip``) and on: the
    donated and the functional update give the same params, m, v and
    count to the bit; the update of whole leaves (``UPDATE_CHUNK`` at its
    default, the form held against JAX) gives the same params, m and v,
    to the bit without the clip and within f32 rounding of the clip
    factor with it (the sliced norm sums the squares in another order,
    and equals ``global_norm``'s to 1e-6 relative).  The functional
    update leaves its params, grads and opt_state as they were."""
    gen = torch.Generator().manual_seed(3)
    params = {"stack": torch.randn(6, 10, 30, generator=gen),
              "embed": torch.randn(50, 16, generator=gen),
              "norm": torch.randn(16, generator=gen)}
    grads = tree_map(lambda p: grad_scale * torch.randn(p.shape,
                                                        generator=gen),
                     params)
    cfg = dataclasses.replace(TCFG, grad_clip=1.0)
    want_norm = float(global_norm(grads))
    assert (want_norm > cfg.grad_clip) == (grad_scale == 1.0)
    opt = adamw_init(params)
    opt["m"] = tree_map(lambda p: 1e-2 * torch.randn(p.shape, generator=gen),
                        params)
    opt["v"] = tree_map(lambda p: 1e-4 * torch.rand(p.shape, generator=gen),
                        params)
    assert all(len(adamw._row_slices(p)) == 1 for p in params.values())
    whole_p, whole_opt = adamw_update(params, grads, opt, 1e-3, cfg)

    monkeypatch.setattr(adamw, "UPDATE_CHUNK", 100)
    assert len(adamw._row_slices(params["stack"])) == 6
    assert len(adamw._row_slices(params["embed"])) == 9
    inputs = tree_map(torch.clone, {"p": params, "g": grads, "opt": opt})
    new_p, new_opt = adamw_update(params, grads, opt, 1e-3, cfg)
    assert _leaves_equal(
        train_state_to_numpy({"p": params, "g": grads, "opt": opt}),
        train_state_to_numpy(inputs))
    p2, opt2 = tree_map(torch.clone, params), tree_map(torch.clone, opt)
    norm = adamw_update_(p2, tree_map(torch.clone, grads), opt2, 1e-3, cfg)
    sliced = {"p": new_p, "m": new_opt["m"], "v": new_opt["v"]}
    assert _leaves_equal(train_state_to_numpy({"p": p2, **opt2}),
                         train_state_to_numpy({"p": new_p, **new_opt}))
    assert int(opt2["count"]) == int(new_opt["count"]) == 1
    np.testing.assert_allclose(float(norm), want_norm, rtol=1e-6)
    whole = {"p": whole_p, "m": whole_opt["m"], "v": whole_opt["v"]}
    if grad_scale < 1.0:
        assert _leaves_equal(train_state_to_numpy(sliced),
                             train_state_to_numpy(whole))
    else:
        for got, want in zip(tree_leaves(sliced), tree_leaves(whole)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-9)


def test_snapshot_is_a_copy():
    """A donated runtime's snapshot is not changed by the next step (numpy
    views of CPU tensors would be)."""
    cfg = get_smoke_config("olmo-1b")
    rt = ElasticRuntime(cfg, TCFG, W, W, G, S, device="cpu", donate=True)
    rt.run_steps(1)
    snap = rt.snapshot()
    frozen = tree_map(np.copy, snap["state"])
    rt.run_steps(1)
    assert _leaves_equal(snap["state"], frozen)
    assert not _leaves_equal(train_state_to_numpy(rt.state), frozen)
