"""The port's hybrid training path (zamba2-1.2b) against the JAX package's,
on the CPU at the zamba2 smoke widths (d_model 256, 16 SSD heads of 32,
state 16, chunk 32; 4 attention heads of 64, window 128; vocab 512).

- ``model_forward``'s loss and every gradient leaf against
  ``jax.value_and_grad(model_forward)`` at 5 layers (two groups of two
  Mamba2 layers, each followed by the one shared attention block, then a
  tail layer: the layout of the full model's 38 = 6 x 6 + 2), remat on
  (one checkpoint per group and per tail layer) and off at f32, and at
  bf16 to a looser bound; the shared block's leaves get the sum of their
  two applications' gradients;
- 5-step ``ElasticRuntime`` trajectories of the smoke config (2 layers:
  one group) against JAX's at splice 1 and 2.

The JAX package draws the weights and the bridge moves them bit for bit;
batches come from numpy seeds.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.elastic import ElasticRuntime as JaxElasticRuntime
from repro.models import model_forward as jax_model_forward
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.models import model_forward
from repro_torch.utils.tree import tree_flatten, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH, LAYERS = "zamba2-1.2b", 5
B, S = 2, 48            # 1.5 chunks of 32
TCFG = dict(total_steps=40, warmup_steps=2, learning_rate=1e-3)
W, G, SEQ, STEPS = 4, 8, 32, 5
# f32 on both sides, summed in other orders: the loss at 1e-5 relative and
# each gradient leaf at 1e-5 of its largest entry
# (tests/test_torch_ssm_train.py's bounds)
F32_TOL = 1e-5


def _cfgs(dtype="float32", layers=LAYERS):
    """Both packages' zamba2 smoke config at ``layers`` (None: its own 2)."""
    changes = dict(dtype=dtype)
    if layers:
        changes["num_layers"] = layers
    return (dataclasses.replace(get_smoke_config(ARCH), **changes),
            dataclasses.replace(jax_smoke_config(ARCH), **changes))


def _close_rel(got, want, tol):
    """|got - want| <= tol * max |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.fixture(scope="module")
def jax_params_np():
    """The JAX package's 5-layer weights, as numpy."""
    from repro.models import init_params as jax_init_params

    _, jcfg = _cfgs()
    return jax.tree_util.tree_map(
        np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX runtime's initial state (numpy) and its 5-step f32 loss
    trajectories at splice 1 and 2, for the smoke config."""
    _, jcfg = _cfgs(layers=None)
    jtcfg = JaxTrainConfig(**TCFG)
    runs = {}
    for physical in (4, 2):
        rt = JaxElasticRuntime(jcfg, jtcfg, W, physical, G, SEQ)
        runs[W // physical] = [r["loss"] for r in rt.run_steps(STEPS)]
    state = JaxElasticRuntime(jcfg, jtcfg, W, W, G, SEQ).state
    return jax.tree_util.tree_map(np.asarray, state), runs


@pytest.mark.parametrize("dtype,remat,loss_tol,tol", [
    ("float32", True, 1e-5, F32_TOL),
    ("float32", False, 1e-5, F32_TOL),
    # bf16 activations round at other places in the two frameworks: the
    # loss at 1e-3 relative, as tests/test_torch_ssm_train.py holds mamba2;
    # each leaf at 6e-2 of its largest entry, twice mamba2's 3e-2 at 2
    # layers, since the roundings compound over 5 layers and two
    # applications of the shared block (readings at 2 layers up to 1.9e-2,
    # at 5 up to 4.0e-2, D's; a fault of structure moves a leaf by O(1))
    ("bfloat16", True, 1e-3, 6e-2),
])
def test_model_forward_loss_and_grads_match_jax(jax_params_np, dtype, remat,
                                                loss_tol, tol):
    cfg, jcfg = _cfgs(dtype)
    tok = np.random.default_rng(0).integers(0, 512, (B, S + 1),
                                            dtype=np.int32)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    params_np = jax_params_np
    params = params_from_jax(params_np, cfg)
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    loss, metrics = model_forward(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        cfg, remat=remat)
    loss.backward()

    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model_forward(p, b, jcfg, remat=remat),
        has_aux=True))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=loss_tol)
    assert metrics["aux"].item() == 0.0
    assert metrics["tokens"].item() == float(jmetrics["tokens"]) == B * S
    got, paths = tree_flatten(params)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    names = ["/".join(path) for path in paths]
    # the Mamba2 stack's 9, the shared block's 9, embed, head, final norm
    assert len(got) == len(jleaves) == 21
    assert {"shared_attn/attn/wq", "shared_attn/mlp/wg",
            "blocks/ssm/A_log"} <= set(names)
    for name, leaf, want in zip(names, got, jleaves):
        assert leaf.grad is not None and leaf.grad.dtype == torch.float32
        assert np.abs(np.asarray(want)).max() > 0, name
        _close_rel(leaf.grad.numpy(), want, tol)


@pytest.mark.parametrize("splice", [1, 2])
def test_elastic_trajectory_matches_jax(jax_runs, splice):
    """5 steps through the port's ElasticRuntime from JAX's state: each
    loss at 1e-5 relative to JAX's (tests/test_torch_elastic.py's bound)."""
    state_np, runs = jax_runs
    cfg, _ = _cfgs(layers=None)
    rt = ElasticRuntime(cfg, TrainConfig(**TCFG), W, W // splice, G, SEQ,
                        state=train_state_from_jax(state_np, cfg),
                        device="cpu")
    hist = rt.run_steps(STEPS)
    assert [h["splice"] for h in hist] == [splice] * STEPS
    assert all(np.isfinite(h["grad_norm"]) for h in hist)
    np.testing.assert_allclose([h["loss"] for h in hist], runs[splice],
                               rtol=1e-5)
    assert set(rt.snapshot()["state"]["params"]) == {
        "embed", "final_norm", "head", "blocks", "shared_attn"}
