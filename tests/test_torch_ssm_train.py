"""The port's SSM training path against the JAX package's, on the CPU at the
mamba2 smoke size (2 layers, d_model 256, 16 SSD heads of 32, state 16,
chunk 32, vocab 512).

- the gradients of ``ssd_chunked`` (through its autograd function, whose
  CPU forward is the kernel's plain version) against ``jax.grad`` of the
  pure-jnp ``repro.models.ssm.ssd_chunked``, and against the Pallas
  ``ssd_chunked_pallas(interpret=True)``: reverse mode does not pass a
  ``pallas_call`` in JAX, forward mode does, so there the port's gradient
  is held against ``jax.jvp`` along random tangents;
- ``model_forward``'s loss and every gradient leaf against
  ``jax.value_and_grad(model_forward)``, remat on and off at f32, and at
  bf16 to a looser bound;
- one spliced train step against the JAX step;
- 5-step ``ElasticRuntime`` trajectories against JAX's at splice 1 and 2.

The JAX package draws the weights and the bridge moves them bit for bit;
inputs and batches come from numpy seeds.
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
from repro.kernels.ssd_scan.ops import ssd_chunked_pallas
from repro.models import model_forward as jax_model_forward
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro.training.state import init_train_state as jax_init_train_state
from repro.training.step import build_train_step as jax_build_train_step
from repro_torch.bridge import (params_from_jax, train_state_from_jax,
                                train_state_to_numpy)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models import model_forward
from repro_torch.training import build_train_step
from repro_torch.utils.tree import tree_flatten, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "mamba2-130m"
B, S = 2, 48            # 48 = 1.5 chunks of 32: the padded path too
TCFG = dict(total_steps=40, warmup_steps=2, learning_rate=1e-3)
W, G, SEQ, STEPS = 4, 8, 32, 5
# f32 on both sides, summed in other orders: the loss at 1e-5 relative
# (tests/test_torch_elastic.py's bound) and each gradient leaf at 1e-5 of
# its largest entry
F32_TOL = 1e-5


def _cfgs(dtype="float32"):
    return (dataclasses.replace(get_smoke_config(ARCH), dtype=dtype),
            dataclasses.replace(jax_smoke_config(ARCH), dtype=dtype))


def _close_rel(got, want, tol):
    """|got - want| <= tol * max |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _batch(seed, b=B, s=S, vocab=512):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1),
                                               dtype=np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


# ---------------------------------------------------------------------------
# The SSD scan's gradient
# ---------------------------------------------------------------------------

SSD_SHAPE = (2, 70, 3, 16, 8, 32)    # (B, L, H, P, N, chunk): L ragged


def _ssd_case(seed=0):
    """x, dt, a, b, c, initial_state and the weights of the scalar loss
    sum(y * wy) + sum(final * ws), all numpy f32."""
    bs, l, h, p, n, _ = SSD_SHAPE
    rng = np.random.default_rng(seed)
    f32 = np.float32
    ins = [rng.standard_normal((bs, l, h, p), dtype=f32),
           np.logaddexp(rng.standard_normal((bs, l, h), dtype=f32),
                        0.0).astype(f32),
           -np.exp(0.1 * rng.standard_normal(h, dtype=f32)).astype(f32),
           rng.standard_normal((bs, l, n), dtype=f32),
           rng.standard_normal((bs, l, n), dtype=f32),
           rng.standard_normal((bs, h, p, n), dtype=f32)]
    weights = (rng.standard_normal((bs, l, h, p), dtype=f32),
               rng.standard_normal((bs, h, p, n), dtype=f32))
    return ins, weights


def _port_ssd_grads(ins, weights):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in ins]
    y, final = ssd_chunked(*ts[:5], SSD_SHAPE[-1], initial_state=ts[5])
    loss = (y * torch.from_numpy(weights[0])).sum() + \
        (final * torch.from_numpy(weights[1])).sum()
    loss.backward()
    return loss.item(), [t.grad.numpy() for t in ts]


def _jax_ssd_loss(fn, weights):
    def loss(x, dt, a, b, c, s0):
        y, final = fn(x, dt, a, b, c, SSD_SHAPE[-1], initial_state=s0)
        return jnp.sum(y * weights[0]) + jnp.sum(final * weights[1])
    return loss


def test_ssd_chunked_grads_match_jax_grad():
    """Every input's gradient, initial_state's too, against jax.grad of the
    pure-jnp scan: 1e-5 of each one's largest entry (f32, other order)."""
    ins, weights = _ssd_case()
    loss, grads = _port_ssd_grads(ins, weights)
    jloss, jgrads = jax.value_and_grad(_jax_ssd_loss(jax_ssd_chunked, weights),
                                       argnums=tuple(range(6)))(
        *map(jnp.asarray, ins))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    for got, want in zip(grads, jgrads):
        _close_rel(got, want, F32_TOL)


@pytest.mark.parametrize("which", range(6))
def test_ssd_chunked_grads_match_pallas_jvp(which):
    """The port's gradient along a random tangent of one input against
    jax.jvp of the Pallas scan in interpret mode: 1e-4 relative (a sum of
    some thousand f32 products of either sign)."""
    ins, weights = _ssd_case(1)
    _, grads = _port_ssd_grads(ins, weights)
    tangent = np.random.default_rng(10 + which).standard_normal(
        ins[which].shape).astype(np.float32)
    tangents = [np.zeros_like(a) for a in ins]
    tangents[which] = tangent
    _, jdot = jax.jvp(
        _jax_ssd_loss(lambda *a, **k: ssd_chunked_pallas(*a, **k,
                                                         interpret=True),
                      weights),
        tuple(map(jnp.asarray, ins)), tuple(map(jnp.asarray, tangents)))
    got = float(np.sum(grads[which].astype(np.float64) * tangent))
    np.testing.assert_allclose(got, float(jdot), rtol=1e-4)


# ---------------------------------------------------------------------------
# The model, a step and the runtime
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_state_np():
    _, jcfg = _cfgs()
    state = jax_init_train_state(jcfg, JaxTrainConfig(**TCFG),
                                 jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, state)


@pytest.mark.parametrize("dtype,remat,loss_tol,tol", [
    ("float32", True, 1e-5, F32_TOL),
    ("float32", False, 1e-5, F32_TOL),
    # bf16 activations round at other places in the two frameworks (the
    # port widens b and c before C B^T, JAX widens the products): the loss
    # at 1e-3 relative, each gradient leaf at 3e-2 of its largest entry,
    # as tests/test_torch_train.py holds olmo
    ("bfloat16", True, 1e-3, 3e-2),
])
def test_model_forward_loss_and_grads_match_jax(jax_state_np, dtype, remat,
                                                loss_tol, tol):
    cfg, jcfg = _cfgs(dtype)
    batch = _batch(0)
    params = params_from_jax(jax_state_np["params"], cfg)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_()
    loss, metrics = model_forward(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        cfg, remat=remat)
    loss.backward()

    jparams = jax.tree_util.tree_map(jnp.asarray, jax_state_np["params"])
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model_forward(p, b, jcfg, remat=remat),
        has_aux=True))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=loss_tol)
    assert metrics["tokens"].item() == float(jmetrics["tokens"]) == B * S
    # both trees in JAX's leaf order (keys sorted at every level)
    got, paths = tree_flatten(params)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(jleaves) == 11
    names = ["/".join(path) for path in paths]
    for name, leaf, want in zip(names, got, jleaves):
        assert leaf.grad is not None and leaf.grad.dtype == torch.float32
        assert np.abs(np.asarray(want)).max() > 0, name
        _close_rel(leaf.grad.numpy(), want, tol)
    # the f32 leaves of the SSM are among them and got a gradient
    assert {"blocks/ssm/A_log", "blocks/ssm/D", "blocks/ssm/dt_bias",
            "blocks/ssm/conv_w"} <= set(names)


def assert_first_adamw_step_close(got, want, m_got, m_want, lr):
    """Params after one AdamW step from one state, on two sides.

    The first step moves an entry by lr (g / (|g| + eps) + wd p), whose
    derivative in g is lr eps / (|g| + eps)^2: a relative change r of g
    moves it by at most lr r / 4, whatever |g|.  Where the two sides'
    gradients (m = (1 - beta1) g) agree to 1e-3 relative, the entries must
    agree to 1e-3 lr.  The others are gradients that cancel to near zero
    and differ in their last bits: under 5% of each leaf, within 0.2 lr.
    (``tests/test_torch_train.py`` splits at |g| = 1e-6 instead; here the
    f32 leaves A_log and dt_bias have every |g| under 4e-6 at this draw,
    yet agree to 4e-6 lr.)"""
    firm = np.abs(m_got - m_want) <= 1e-3 * np.abs(m_want)
    assert 1 - firm.mean() < 0.05, f"{1 - firm.mean():.3g} of the leaf loose"
    np.testing.assert_allclose(got[firm], want[firm], rtol=0, atol=1e-3 * lr)
    np.testing.assert_allclose(got[~firm], want[~firm], rtol=0, atol=0.2 * lr)


@pytest.mark.parametrize("splice", [1, 2])
def test_train_step_matches_jax(jax_state_np, splice):
    """One spliced step from one bridged state: loss, lr, grad_norm, the
    barrier payload, m and v at 1e-5 of each leaf's largest entry, and
    params as ``assert_first_adamw_step_close`` says."""
    cfg, jcfg = _cfgs()
    batch = _batch(1, b=4, s=SEQ)
    state = train_state_from_jax(jax_state_np, cfg)
    flags = np.array([[1, 0], [0, 1]], np.int32)
    new, metrics = build_train_step(cfg, TrainConfig(**TCFG), splice=splice,
                                    with_barrier=True)(
        state, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        torch.from_numpy(flags))
    jstate = jax.tree_util.tree_map(jnp.asarray, jax_state_np)
    jnew, jmetrics = jax.jit(jax_build_train_step(
        jcfg, JaxTrainConfig(**TCFG), splice=splice, with_barrier=True))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jnp.asarray(flags))
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                   rtol=1e-5)
    assert metrics["barrier"].tolist() == [1, 1]
    assert int(new["step"]) == int(jnew["step"]) == 1
    got = train_state_to_numpy(new)
    want = jax.tree_util.tree_map(np.asarray, jnew)
    for part in ("m", "v"):
        for gl, wl in zip(jax.tree_util.tree_leaves(got["opt"][part]),
                          jax.tree_util.tree_leaves(want["opt"][part])):
            _close_rel(gl, wl, F32_TOL)
    lr = float(jmetrics["lr"])
    for gl, wl, gm, wm in zip(*(jax.tree_util.tree_leaves(t) for t in (
            got["params"], want["params"], got["opt"]["m"],
            want["opt"]["m"]))):
        assert_first_adamw_step_close(gl, wl, gm, wm, lr)
    # A_log, D and dt_bias moved, and stay f32
    for key in ("A_log", "D", "dt_bias"):
        leaf = new["params"]["blocks"]["ssm"][key]
        assert leaf.dtype == torch.float32
        assert not torch.equal(leaf, state["params"]["blocks"]["ssm"][key])


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX runtime's initial state (numpy) and its 5-step f32 loss
    trajectories at splice 1 and 2."""
    _, jcfg = _cfgs()
    jtcfg = JaxTrainConfig(**TCFG)
    runs = {}
    for physical in (4, 2):
        rt = JaxElasticRuntime(jcfg, jtcfg, W, physical, G, SEQ)
        runs[W // physical] = [r["loss"] for r in rt.run_steps(STEPS)]
    state = JaxElasticRuntime(jcfg, jtcfg, W, W, G, SEQ).state
    return jax.tree_util.tree_map(np.asarray, state), runs


@pytest.mark.parametrize("splice", [1, 2])
def test_elastic_trajectory_matches_jax(jax_runs, splice):
    """5 steps through the port's ElasticRuntime from JAX's state: each
    loss at 1e-5 relative to JAX's (tests/test_torch_elastic.py's bound)."""
    state_np, runs = jax_runs
    cfg, _ = _cfgs()
    rt = ElasticRuntime(cfg, TrainConfig(**TCFG), W, W // splice, G, SEQ,
                        state=train_state_from_jax(state_np, cfg),
                        device="cpu")
    hist = rt.run_steps(STEPS)
    assert [h["splice"] for h in hist] == [splice] * STEPS
    assert all(np.isfinite(h["grad_norm"]) for h in hist)
    np.testing.assert_allclose([h["loss"] for h in hist], runs[splice],
                               rtol=1e-5)
    snap = rt.snapshot()
    assert set(snap["state"]["params"]["blocks"]["ssm"]) == {
        "in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
        "norm_scale", "out_proj"}
    assert snap["pipeline"] == {"seed": 0, "step": STEPS}
