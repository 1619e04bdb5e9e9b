"""The remat policies of the port's training forward, on the CPU in f32.

``remat_policy="dots"`` (JAX's ``dots_saveable``: the matmul outputs saved,
the rest recomputed in the backward) must give the loss and gradients of
``"full"`` (whole units recomputed) and of no remat, for every trained
family: dense (olmo-1b), MoE (granite-moe-3b-a800m), SSM (mamba2-130m),
hybrid (zamba2-1.2b at 3 layers: a group and a tail layer), audio
(whisper-base: the encoder outside the checkpoints, then a unit per
decoder layer and its cross block) and VLM (llama-3.2-vision-11b at 4
layers: two groups, each with its cross block), with the cross gates set
nonzero so that the cross blocks reach the loss.  On the CPU
each policy runs the same f32 operations in the same order, so the
gradients are equal to the bit.  No JAX: ``tests/test_torch_train.py`` and
its siblings hold the "full" gradients against ``jax.grad``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import CheckpointPolicy

from repro_torch.configs import get_smoke_config
from repro_torch.models import init_params, model_forward
from repro_torch.models import model as model_lib
from repro_torch.models.frontend import synth_extra_inputs
from repro_torch.utils.tree import tree_leaves, tree_unflatten


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = {"olmo-1b": None, "granite-moe-3b-a800m": None, "mamba2-130m": None,
         "zamba2-1.2b": 3, "whisper-base": None, "llama-3.2-vision-11b": 4}


class _CountMatmuls(TorchDispatchMode):
    """Counts the matmuls that run (a product the policy saved is handed
    back by the checkpoint's own mode, inside this one, and not counted)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in model_lib._DOTS
        return func(*args, **(kwargs or {}))


def _grads(cfg, params, batch, remat, policy):
    """Loss, aux, gradients and the matmuls run in the backward."""
    leaves = tree_leaves(params)
    xs = [leaf.detach().requires_grad_() for leaf in leaves]
    loss, metrics = model_forward(tree_unflatten(params, xs), batch, cfg,
                                  remat=remat, remat_policy=policy)
    with _CountMatmuls() as count:
        grads = torch.autograd.grad(loss, xs)
    return loss, metrics["aux"], grads, count.n


@pytest.mark.parametrize("arch", list(CASES))
def test_dots_policy_gives_the_gradients_of_full(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    if CASES[arch]:
        cfg = dataclasses.replace(cfg, num_layers=CASES[arch])
    params = init_params(cfg, 0, device="cpu")
    if "cross" in params:
        gate = params["cross"]["gate"]
        gate.copy_(torch.from_numpy(np.random.default_rng(1).uniform(
            0.3, 0.9, gate.shape)))
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 49))
    batch = {"tokens": torch.from_numpy(tok[:, :-1]),
             "labels": torch.from_numpy(tok[:, 1:]),
             **synth_extra_inputs(cfg, 2, 0)}
    full = _grads(cfg, params, batch, True, "full")
    backward_matmuls = {}
    for remat, policy in ((True, "dots"), (False, "full")):
        loss, aux, grads, backward_matmuls[remat] = _grads(
            cfg, params, batch, remat, policy)
        assert torch.equal(loss, full[0]) and torch.equal(aux, full[1])
        assert len(grads) == len(full[2])
        for got, want in zip(grads, full[2]):
            assert torch.equal(got, want), (arch, remat, policy)
    assert any(g.abs().max() > 0 for g in full[2])
    # "dots" recomputes no matmul: its backward runs those of no remat,
    # "full" runs the forward's again on top of them
    assert backward_matmuls[True] == backward_matmuls[False] < full[3]


def test_dots_policy_saves_the_matmuls_only():
    """The policy keeps mm, bmm, addmm and baddbmm (what einsum and matmul
    reach) and recomputes anything else, the kernels' wrappers included."""
    aten = torch.ops.aten
    for op in (aten.mm.default, aten.bmm.default, aten.addmm.default,
               aten.baddbmm.default):
        assert model_lib._save_dots(None, op) == CheckpointPolicy.MUST_SAVE
    for op in (aten.add.Tensor, aten.exp.default, aten.softmax.int,
               aten.index_put.default):
        assert model_lib._save_dots(None, op) == \
            CheckpointPolicy.PREFER_RECOMPUTE


def test_hybrid_remat_checkpoints_each_group_once():
    """zamba2 at 5 layers under remat: one checkpoint per group (two Mamba2
    layers and the shared block) and one per tail layer, as JAX wraps its
    group and tail scans' steps: 3 units, not 5 + 2."""
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"),
                              dtype="float32", num_layers=5)
    units = list(model_lib._train_units(cfg,
                                        init_params(cfg, 0, device="cpu")))
    assert [fn.__name__ for fn, _ in units] == [
        "_hybrid_group", "_hybrid_group", "_ssm_block"]
    (blocks, shared), _ = units[0][1], units[1][1]
    assert len(blocks) == 2 and shared is units[1][1][1]
