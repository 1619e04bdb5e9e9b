"""The port's training pieces against the JAX package, on the CPU at the
olmo smoke size (2 layers, d 256, 4 heads of 64, vocab 512).

- ``model_forward``'s loss and every gradient leaf against
  ``jax.value_and_grad(model_forward)``, remat on and off, f32 and bf16;
- one spliced train step (splice 1 and 2) against the JAX step;
- ``adamw_update``, ``global_norm`` and ``lr_schedule`` on random trees;
- ``DataPipeline`` tokens bit-equal to the JAX package's;
- the train-state bridge, bit-exact both ways;
- the ``repro_torch.launch.train`` command on the CPU.

The JAX package draws the weights; the bridge moves them into the port bit
for bit; batches and trees come from numpy seeds.  f32 compares at 1e-5
relative to the largest entry (the same f32 arithmetic summed in another
order), bf16 at the looser bound stated where it is used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.data.pipeline import DataPipeline as JaxDataPipeline
from repro.models import model_forward as jax_model_forward
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.optim.schedule import lr_schedule as jax_lr_schedule
from repro.training.state import init_train_state as jax_init_train_state
from repro.training.step import build_train_step as jax_build_train_step
from repro_torch.bridge import (params_from_jax, train_state_from_jax,
                                train_state_to_numpy)
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataPipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import model_forward
from repro_torch.optim import adamw as adamw_module
from repro_torch.optim import adamw_init, adamw_update, lr_schedule
from repro_torch.optim.adamw import global_norm
from repro_torch.training import build_train_step, init_train_state
from repro_torch.utils.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, S = 2, 32
TCFG = dict(total_steps=40, warmup_steps=2, learning_rate=1e-3)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(get_smoke_config("olmo-1b"), dtype=dtype),
            dataclasses.replace(jax_smoke_config("olmo-1b"), dtype=dtype))


@pytest.fixture(scope="module")
def jax_state_np():
    _, jcfg = _cfgs()
    state = jax_init_train_state(jcfg, JaxTrainConfig(**TCFG),
                                 jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, state)


def _batch(seed, b=B, s=S, vocab=512):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1),
                                               dtype=np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


def assert_first_adamw_step_close(got, want, m, lr, beta1=0.9, eps=1e-8):
    """Params after one AdamW step from one state, on two sides.

    The first step moves an entry by lr (g / (|g| + eps) + wd p).  Where
    |g| >= 1e-6 (100 eps; g = m / (1 - beta1)) a change dg moves it by at
    most 1e4 lr dg: there the sides agree to 1e-3 lr.  Where |g| < 1e-6 the
    ratio rests on g's last bits: those entries must be under 5% of each
    leaf (1.9% at most here) and agree to 0.2 lr (0.075 lr at most here),
    so an update flipped in sign is caught wherever it moves an entry by
    more than 0.1 lr (|g| > 0.11 eps)."""
    firm = np.abs(m) / (1 - beta1) >= 1e-6
    assert 1 - firm.mean() < 0.05, f"{1 - firm.mean():.3g} of the leaf loose"
    np.testing.assert_allclose(got[firm], want[firm], rtol=0, atol=1e-3 * lr)
    np.testing.assert_allclose(got[~firm], want[~firm], rtol=0, atol=0.2 * lr)


def _close_rel(got, want, tol):
    """|got - want| <= tol * max |want|, leaf by leaf."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,remat,tol", [
    ("float32", True, 1e-5),
    ("float32", False, 1e-5),
    # bf16 activations round at other places in the two frameworks (8 bits
    # of mantissa through 2 layers): loss at 1e-3, gradients at 3e-2 of
    # each leaf's largest entry
    ("bfloat16", True, 3e-2),
])
def test_model_forward_loss_and_grads_match_jax(jax_state_np, dtype, remat,
                                                tol):
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
    np.testing.assert_allclose(loss.item(), float(jloss),
                               rtol=1e-5 if dtype == "float32" else 1e-3)
    assert metrics["tokens"].item() == float(jmetrics["tokens"]) == B * S
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(jleaves) == len(leaves) == 8   # the None norms carry none
    for leaf, want in zip(leaves, jleaves):
        assert leaf.grad is not None and leaf.grad.dtype == torch.float32
        _close_rel(leaf.grad.numpy(), want, tol)


def test_every_family_builds_a_train_state_under_dots():
    """All six families (dense, MoE, SSM, hybrid, audio, VLM) build a train
    state under the "dots" remat policy ("dots" gives the gradients of
    "full": ``tests/test_torch_remat.py``), f32 master weights with the
    cross gates f32 scalars; an unknown family raises."""
    for arch in ("olmo-1b", "granite-moe-3b-a800m", "mamba2-130m",
                 "zamba2-1.2b", "whisper-base", "llama-3.2-vision-11b"):
        state = init_train_state(get_smoke_config(arch),
                                 TrainConfig(remat_policy="dots"),
                                 device="cpu")
        assert all(leaf.dtype == torch.float32
                   for leaf in tree_leaves(state["params"]))
    with pytest.raises(ValueError, match="unknown arch_type"):
        init_train_state(dataclasses.replace(get_smoke_config("olmo-1b"),
                                             arch_type="diffusion"),
                         TrainConfig(), device="cpu")


@pytest.mark.parametrize("splice", [1, 2])
def test_train_step_matches_jax(jax_state_np, splice):
    """One spliced step from one bridged state: loss, lr, grad_norm, the
    barrier payload and every updated leaf of params, m and v."""
    cfg, jcfg = _cfgs()
    batch = _batch(1, b=4)
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
    assert int(new["opt"]["count"]) == 1
    got = train_state_to_numpy(new)
    want = jax.tree_util.tree_map(np.asarray, jnew)
    # m and v carry the gradients: 1e-5 of each leaf's largest entry
    for g, w in ((got["opt"]["m"], want["opt"]["m"]),
                 (got["opt"]["v"], want["opt"]["v"])):
        for gl, wl in zip(jax.tree_util.tree_leaves(g),
                          jax.tree_util.tree_leaves(w)):
            _close_rel(gl, wl, 1e-5)
    lr = float(jmetrics["lr"])
    for gl, wl, ml in zip(jax.tree_util.tree_leaves(got["params"]),
                          jax.tree_util.tree_leaves(want["params"]),
                          jax.tree_util.tree_leaves(want["opt"]["m"])):
        assert_first_adamw_step_close(gl, wl, ml, lr)
    # the state passed in is left as it was
    np.testing.assert_array_equal(
        state["params"]["embed"].numpy(), jax_state_np["params"]["embed"])


def _random_tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32), "n": None,
                  "d": (3 * rng.standard_normal((2, 2))).astype(np.float32)}}


@pytest.mark.parametrize("seed,grad_scale,chunk", [
    (0, 1.0, None), (1, 0.05, None), (0, 1.0, 4), (1, 0.05, 4)],
    ids=["0-1.0", "1-0.05", "0-1.0-sliced", "1-0.05-sliced"])
def test_adamw_update_matches_jax(monkeypatch, seed, grad_scale, chunk):
    """Three updates on a random tree with a None leaf; grad_scale 1 clips
    (global norm > grad_clip 1.0), 0.05 does not.  ``sliced``: every leaf
    of more than one row cut into axis-0 slices (``UPDATE_CHUNK`` of 4
    elements, as a full-width leaf is cut at 16M), the norm summed and the
    update run slice by slice."""
    if chunk is not None:
        monkeypatch.setattr(adamw_module, "UPDATE_CHUNK", chunk)
        assert len(adamw_module._row_slices(torch.zeros(3, 4))) == 3
        assert len(adamw_module._row_slices(torch.zeros(5))) == 2
    rng = np.random.default_rng(seed)
    tcfg = TrainConfig(**TCFG)
    jtcfg = JaxTrainConfig(**TCFG)
    params = _random_tree(rng)
    tp = jax.tree_util.tree_map(torch.from_numpy, params)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt, jopt = adamw_init(tp), jax_adamw_init(jp)
    assert opt["m"]["b"]["n"] is None and int(opt["count"]) == 0
    for step in range(3):
        grads = jax.tree_util.tree_map(
            lambda a: (grad_scale * rng.standard_normal(a.shape))
            .astype(np.float32), params)
        tg = jax.tree_util.tree_map(torch.from_numpy, grads)
        jg = jax.tree_util.tree_map(jnp.asarray, grads)
        np.testing.assert_allclose(global_norm(tg).item(),
                                   float(jnp.sqrt(sum(
                                       jnp.sum(jnp.square(x)) for x in
                                       jax.tree_util.tree_leaves(jg)))),
                                   rtol=1e-6)
        lr = lr_schedule(step, tcfg)
        tp, opt = adamw_update(tp, tg, opt, lr, tcfg)
        jp, jopt = jax_adamw_update(jp, jg, jopt,
                                    jax_lr_schedule(step, jtcfg), jtcfg)
    assert int(opt["count"]) == int(jopt["count"]) == 3
    assert tp["b"]["n"] is None and opt["v"]["b"]["n"] is None
    for got, want in ((tp, jp), (opt["m"], jopt["m"]), (opt["v"], jopt["v"])):
        for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-7)


def test_adamw_keeps_the_param_dtype():
    tp = {"w": torch.ones(4, dtype=torch.bfloat16)}
    new, opt = adamw_update(tp, {"w": torch.ones(4)}, adamw_init(tp), 1e-2,
                            TrainConfig())
    assert new["w"].dtype == torch.bfloat16
    assert opt["m"]["w"].dtype == torch.float32


def test_lr_schedule_matches_jax():
    for kw in (TCFG, dict(total_steps=1000, warmup_steps=100,
                          learning_rate=3e-4), dict(warmup_steps=0)):
        tcfg, jtcfg = TrainConfig(**kw), JaxTrainConfig(**kw)
        for step in (0, 1, 2, 5, 39, 99, 100, 500, 999, 1000, 5000):
            got = lr_schedule(step, tcfg)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                got.item(), float(jax_lr_schedule(step, jtcfg)), rtol=1e-6)
            np.testing.assert_allclose(
                lr_schedule(torch.tensor(step, dtype=torch.int32),
                            tcfg).item(),
                float(jax_lr_schedule(jnp.int32(step), jtcfg)), rtol=1e-6)


@pytest.mark.parametrize("vocab,seq,gb,world,seed", [
    (512, 32, 8, 4, 0), (50304, 64, 4, 4, 7), (100, 16, 6, 2, 3)])
def test_pipeline_tokens_bit_equal_to_jax(vocab, seq, gb, world, seed):
    ours = DataPipeline(vocab, seq, gb, world, seed=seed)
    want = JaxDataPipeline(vocab, seq, gb, world, seed=seed)
    for _ in range(3):
        for a, b in zip(ours.next_batch(), want.next_batch()):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.batch_for_ranks([1], step=9)[0],
                                  want.batch_for_ranks([1], step=9)[0])
    assert ours.snapshot() == want.snapshot()


def test_train_state_bridge_round_trip_is_bit_exact(jax_state_np):
    cfg, _ = _cfgs()
    state = train_state_from_jax(jax_state_np, cfg, device="cpu")
    assert state["params"]["final_norm"] is None
    assert state["opt"]["m"]["blocks"]["ln1"] is None
    assert state["step"].dtype == state["opt"]["count"].dtype == torch.int32
    back = train_state_to_numpy(state)

    def same(a, b):
        assert (a is None) == (b is None)
        if isinstance(a, dict):
            assert list(a) == list(b)          # keys and order
            for key in a:
                same(a[key], b[key])
        elif a is not None:
            assert a.shape == b.shape and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    same(back, jax_state_np)
    ours = train_state_to_numpy(init_train_state(cfg, TrainConfig(**TCFG),
                                                 device="cpu"))
    # the JAX init_train_state's own key order (tree_map sorts keys)
    assert list(ours) == ["params", "opt", "step"]
    assert list(ours["opt"]) == ["m", "v", "count"]


def test_train_command_runs_on_cpu(capsys, tmp_path):
    out = tmp_path / "hist.json"
    train_cli.main(["--device", "cpu", "--steps", "4", "--resize", "2:2",
                    "--out", str(out)])
    text = capsys.readouterr().out
    assert "[resize]" in text and "splice=2" in text and "done: 4 steps" in text
    import json
    hist = json.loads(out.read_text())["history"]
    assert [h["splice"] for h in hist] == [1, 1, 2, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_train_command_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--steps", "1"])


def test_train_command_refuses_checkpoints(capsys):
    """A negative checkpoint interval is refused (0 takes none; a positive
    one works, tests/test_torch_migration.py)."""
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--device", "cpu", "--ckpt-every", "-2"])
    assert exc.value.code == 2
    assert "--ckpt-every must be >= 0" in capsys.readouterr().err


def test_full_olmo_train_state_shapes():
    """The full config's parameter count, without drawing its weights."""
    cfg = get_config("olmo-1b")
    assert cfg.arch_type == "dense" and cfg.tie_embeddings
    assert 1.17e9 < cfg.param_count() < 1.19e9
