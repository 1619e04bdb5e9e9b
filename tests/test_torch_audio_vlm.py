"""The port's audio (whisper-base) and VLM (llama-3.2-vision-11b) families
against the JAX package's, on the CPU at their smoke sizes (d_model 256,
4 heads of 64; whisper: 2 decoder and 2 encoder layers over 64 frames;
llama-vision: 4 layers, 2 of them per cross block, 16 image tokens of 64,
GQA 4 to 1; vocab 512).

- the plain non-causal attention core against ``blockwise_attention
  (causal=False)`` with ragged Sq and Skv (Skv past one 512-key block),
  and the cross cache and cross decode against JAX's;
- ``_encoder_forward``;
- prefill logits, the decode state (``kv`` and ``cross_kv``) and 8 greedy
  tokens;
- ``model_forward``'s loss and gradients, remat on and off, against
  ``jax.value_and_grad`` at f32, and at bf16 to a looser bound;
- 5-step whisper ``ElasticRuntime`` trajectories at splice 1 and 2 from
  JAX's state, with JAX's frames carried across; one spliced VLM step.

The cross-attention gates are zero at init, where every cross block adds
nothing; every test here first sets them to values in [0.3, 0.9] drawn
from a numpy seed, the same on both sides.  The JAX package draws the
weights and the frame and patch embeddings, which cross through numpy; the
bridge moves the weights bit for bit.
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
from repro.models import attention as jax_attn
from repro.models import decode_step_fn as jax_decode_step_fn
from repro.models import model as jax_model
from repro.models import model_forward as jax_model_forward
from repro.models import prefill_fn as jax_prefill_fn
from repro.models.frontend import synth_extra_inputs as jax_synth
from repro.training.step import build_train_step as jax_build_train_step
from repro_torch.bridge import (params_from_jax, params_to_numpy,
                                train_state_from_jax)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.models import (decode_step_fn, init_params, model_forward,
                                prefill_fn)
from repro_torch.models import attention as attn
from repro_torch.models import model as model_lib
from repro_torch.training import build_train_step
from repro_torch.utils.tree import tree_flatten, tree_leaves
from test_torch_ssm_train import assert_first_adamw_step_close

ARCHS = {"whisper-base": None, "llama-3.2-vision-11b": 4}
B, S, NEW = 2, 24, 8
TCFG = dict(total_steps=40, warmup_steps=2, learning_rate=1e-3)
W, G, SEQ, STEPS = 4, 8, 32, 5
# f32 on both sides, summed in other orders: logits and decode state at
# rtol/atol 1e-4 (tests/test_torch_model.py), outputs and gradient leaves
# at 1e-5 of their largest entry, losses at 1e-5 relative
TOL = dict(rtol=1e-4, atol=1e-4)
F32_TOL = 1e-5


def _cfgs(arch, dtype="float32"):
    """Both packages' smoke config of ``arch``, at ``ARCHS[arch]`` layers."""
    changes = dict(dtype=dtype)
    if ARCHS[arch]:
        changes["num_layers"] = ARCHS[arch]
    return (dataclasses.replace(get_smoke_config(arch), **changes),
            dataclasses.replace(jax_smoke_config(arch), **changes))


def _set_gates(params, seed):
    """The cross gates of a numpy tree set to uniform [0.3, 0.9) (f32)."""
    gate = params["cross"]["gate"]
    params["cross"]["gate"] = np.random.default_rng(seed).uniform(
        0.3, 0.9, gate.shape).astype(np.float32)
    return params


def _close_rel(got, want, tol):
    """|got - want| <= tol * max |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _extras(jcfg, b, seed=7):
    """JAX's frame or patch embeddings, as numpy."""
    return {k: np.asarray(v) for k, v in
            jax_synth(jcfg, b, jax.random.PRNGKey(seed)).items()}


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype.kind in "iu"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _draw(tree, rng, key=""):
    """A tree of the same shapes drawn from ``rng``: norm scales
    1 + 0.1 N(0, 1), norm biases 0.1 N(0, 1), weights 0.02 N(0, 1)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _draw(v, rng, k) for k, v in tree.items()}
    shift, scale = {"scale": (1.0, 0.1), "bias": (0.0, 0.1)}.get(
        key, (0.0, 0.02))
    return (shift + scale * rng.standard_normal(tree.shape)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_params_np():
    """Each family's weights (numpy, in the JAX tree), gates set."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg, _ = _cfgs(arch)
        params = _draw(params_to_numpy(init_params(cfg, 0, device="cpu")),
                       np.random.default_rng(i))
        out[arch] = _set_gates(params, i)
    return out


# ---------------------------------------------------------------------------
# Attention cores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv", [(37, 600), (45, 45), (1, 77)])
def test_full_attention_matches_blockwise(sq, skv):
    """Every query over every key (JAX runs blocks of 512 with an online
    softmax; the plain core one block): 1e-5 of the largest output."""
    rng = np.random.default_rng(sq + skv)
    q, k, v = (rng.standard_normal((2, n, 4, 32)).astype(np.float32)
               for n in (sq, skv, skv))
    got = attn.full_attention(*map(torch.from_numpy, (q, k, v)))
    want = jax_attn.blockwise_attention(*map(jnp.asarray, (q, k, v)),
                                        causal=False)
    assert got.shape == (2, sq, 4, 32)
    _close_rel(got.numpy(), want, F32_TOL)


def _attn_params(rng, d, h, kvh, hd):
    return {name: (0.05 * rng.standard_normal(shape)).astype(np.float32)
            for name, shape in (("wq", (d, h, hd)), ("wk", (d, kvh, hd)),
                                ("wv", (d, kvh, hd)), ("wo", (h, hd, d)))}


def test_cross_cache_and_cross_decode_match_jax():
    """GQA 4 to 2: the cross K/V, one token's cross attention over them,
    and the same token through the layer's ``kv=`` path."""
    rng = np.random.default_rng(3)
    p = _attn_params(rng, 64, 4, 2, 16)
    src = rng.standard_normal((2, 33, 64)).astype(np.float32)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    cache = attn.init_cross_cache(pt, torch.from_numpy(src), num_kv_heads=2)
    jcache = jax_attn.init_cross_cache(jp, jnp.asarray(src), num_kv_heads=2)
    for name in ("k", "v"):
        assert cache[name].shape == (2, 33, 2, 16)
        _close_rel(cache[name].numpy(), jcache[name], F32_TOL)
    out = attn.decode_cross_attention(pt, torch.from_numpy(x), cache,
                                      num_heads=4)
    _close_rel(out.numpy(), jax_attn.decode_cross_attention(
        jp, jnp.asarray(x), jcache, num_heads=4), F32_TOL)
    layer = attn.attention_forward(pt, torch.from_numpy(x), num_heads=4,
                                   num_kv_heads=2, rope_theta=0.0,
                                   kv=torch.from_numpy(src), causal=False)
    _close_rel(layer.numpy(), out.numpy(), F32_TOL)


# ---------------------------------------------------------------------------
# The encoder, serving
# ---------------------------------------------------------------------------

def test_gates_stay_f32_and_encoder_matches_jax(jax_params_np):
    """Gates are f32 scalars per cross block, zero at init, kept f32 under
    bf16 parameters (init and bridge); ``_encoder_forward`` over JAX's
    frames at 1e-5 of its largest output."""
    arch = "whisper-base"
    cfg, jcfg = _cfgs(arch)
    bf16 = dataclasses.replace(cfg, dtype="bfloat16")
    for params in (init_params(bf16, 0, device="cpu", dtype=torch.bfloat16),
                   params_from_jax(jax_params_np[arch], bf16,
                                   dtype=torch.bfloat16)):
        assert params["cross"]["gate"].dtype == torch.float32
        assert params["cross"]["gate"].shape == (cfg.num_layers,)
        assert params["cross"]["attn"]["wq"].dtype == torch.bfloat16
    assert not init_params(cfg, 0, device="cpu")["cross"]["gate"].any()
    params = params_from_jax(jax_params_np[arch], cfg)
    frames = _extras(jcfg, B)["encoder_frames"].copy()
    assert frames.shape == (B, 64, 256)
    got = model_lib._encoder_forward(cfg, params, torch.from_numpy(frames))
    want = jax_model._encoder_forward(
        jcfg, jax.tree_util.tree_map(jnp.asarray, jax_params_np[arch]),
        jnp.asarray(frames))
    _close_rel(got.numpy(), want, F32_TOL)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_decode_state_and_greedy_tokens_match_jax(jax_params_np,
                                                          arch):
    cfg, jcfg = _cfgs(arch)
    params = params_from_jax(jax_params_np[arch], cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_params_np[arch])
    prompt = np.random.default_rng(1).integers(0, 512, (B, S),
                                               dtype=np.int32)
    batch = {"tokens": prompt, **_extras(jcfg, B)}
    clen = S + NEW
    logits, state = prefill_fn(params, _torch(batch), cfg, cache_len=clen)
    jlogits, jstate = jax.jit(lambda p, b: jax_prefill_fn(
        p, b, jcfg, cache_len=clen))(jparams, jax.tree_util.tree_map(
            jnp.asarray, batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert state["pos"] == int(jstate["pos"]) == S
    assert set(state) == set(jstate) == {"pos", "kv", "cross_kv"}
    n_cross = cfg.num_layers if arch == "whisper-base" else 2
    for key in ("kv", "cross_kv"):
        for name in ("k", "v"):
            got, want = state[key][name], np.asarray(jstate[key][name])
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert state["cross_kv"]["k"].shape[0] == n_cross

    jdecode = jax.jit(lambda p, s, t: jax_decode_step_fn(p, s, t, jcfg))
    tok = logits.argmax(-1).to(torch.int32)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    toks, jtoks = [tok], [jtok]
    for _ in range(NEW - 1):
        logits, state = decode_step_fn(params, state, tok, cfg)
        jlogits, jstate = jdecode(jparams, jstate, jtok)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL)
        tok = logits.argmax(-1).to(torch.int32)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        toks.append(tok)
        jtoks.append(jtok)
    np.testing.assert_array_equal(torch.stack(toks, 1).numpy(),
                                  np.asarray(jnp.stack(jtoks, 1)))
    for name in ("k", "v"):
        np.testing.assert_allclose(state["kv"][name].numpy(),
                                   np.asarray(jstate["kv"][name]), **TOL)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _batch(jcfg, seed, b=B, s=S):
    tok = np.random.default_rng(seed).integers(0, 512, (b, s + 1),
                                               dtype=np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:],
            **_extras(jcfg, b, seed)}


@pytest.fixture(scope="module")
def jax_grads():
    """JAX's loss and gradients per (arch, dtype), remat on, computed once:
    JAX's remat changes no value, so the port's remat on and off are both
    held against these."""
    cache = {}

    def get(arch, dtype, params_np, batch):
        if (arch, dtype) not in cache:
            _, jcfg = _cfgs(arch, dtype)
            (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
                lambda p, b: jax_model_forward(p, b, jcfg, remat=True),
                has_aux=True))(
                jax.tree_util.tree_map(jnp.asarray, params_np),
                jax.tree_util.tree_map(jnp.asarray, batch))
            cache[arch, dtype] = (float(jloss), float(jmetrics["tokens"]),
                                  jax.tree_util.tree_leaves(jgrads))
        return cache[arch, dtype]

    return get


@pytest.mark.parametrize("arch", list(ARCHS))
@pytest.mark.parametrize("dtype,remat,loss_tol,tol", [
    ("float32", True, 1e-5, F32_TOL),
    ("float32", False, 1e-5, F32_TOL),
    # bf16 activations round at other places in the two frameworks: the
    # loss at 1e-3 relative and each leaf at 3e-2 of its largest entry
    # (tests/test_torch_ssm_train.py's bf16 bounds); the gates see below
    ("bfloat16", True, 1e-3, 3e-2),
])
def test_model_forward_loss_and_grads_match_jax(jax_params_np, jax_grads,
                                                arch, dtype, remat, loss_tol,
                                                tol):
    """Every leaf has a nonzero gradient (the gates, the encoder or the
    projector included) and agrees with ``jax.grad``'s.

    A gate's gradient is one sum over every token and channel of the
    cross block's output, which cancels to 1% of its terms here; at bf16
    JAX's reduction rounds it coarsely (whisper's first gate reads 2.5e-3
    against the f32 gradient's 1.11e-3, the port's 1.40e-3).  So at bf16
    the gates are held against the f32 gradient, at 5e-2 of its largest
    entry."""
    cfg, jcfg = _cfgs(arch, dtype)
    batch = _batch(jcfg, 0)
    params = params_from_jax(jax_params_np[arch], cfg)
    for leaf in tree_leaves(params):
        leaf.requires_grad_()
    loss, metrics = model_forward(params, _torch(batch), cfg, remat=remat)
    loss.backward()
    jloss, jtokens, jleaves = jax_grads(arch, dtype, jax_params_np[arch],
                                        batch)
    np.testing.assert_allclose(loss.item(), jloss, rtol=loss_tol)
    assert metrics["tokens"].item() == jtokens == B * S
    got, paths = tree_flatten(params)
    names = ["/".join(path) for path in paths]
    assert len(got) == len(jleaves)
    assert "cross/gate" in names
    assert ("encoder/blocks/attn/wq" in names) == (arch == "whisper-base")
    assert ("projector" in names) == (arch != "whisper-base")
    f32_leaves = jax_grads(arch, "float32", jax_params_np[arch], batch)[2]
    for name, leaf, want, want32 in zip(names, got, jleaves, f32_leaves):
        assert leaf.grad is not None and leaf.grad.dtype == torch.float32
        assert np.abs(np.asarray(want)).max() > 0, name
        if name == "cross/gate" and dtype == "bfloat16":
            _close_rel(leaf.grad.numpy(), want32, 5e-2)
        else:
            _close_rel(leaf.grad.numpy(), want, tol)


@pytest.fixture(scope="module")
def jax_state_np(jax_params_np):
    """Each family's JAX train state (numpy) over its weights, gates set:
    JAX's ``init_train_state`` without drawing the weights again."""
    from repro.optim.adamw import adamw_init as jax_adamw_init

    return {arch: jax.tree_util.tree_map(np.asarray, {
        "params": params, "opt": jax_adamw_init(params),
        "step": jnp.zeros((), jnp.int32)})
        for arch, params in jax_params_np.items()}


@pytest.fixture(scope="module")
def jax_run(jax_state_np):
    """JAX's whisper runtime at splice 2 from the state with gates set: its
    5-step loss trajectory and the frames it drew and put in each batch."""
    _, jcfg = _cfgs("whisper-base")
    rt = JaxElasticRuntime(
        jcfg, JaxTrainConfig(**TCFG), W, W // 2, G, SEQ,
        state=jax.tree_util.tree_map(jnp.asarray,
                                     jax_state_np["whisper-base"]))
    losses = [r["loss"] for r in rt.run_steps(STEPS)]
    extra = {k: np.asarray(v) for k, v in rt._batch().items()
             if k not in ("tokens", "labels")}
    return losses, extra


@pytest.mark.parametrize("splice", [1, 2])
def test_whisper_trajectory_matches_jax(jax_state_np, jax_run, splice):
    """5 steps through the port's ElasticRuntime at splice 1 and 2 from
    JAX's state, with JAX's frames passed in: each loss at 1e-5 relative to
    JAX's runtime at splice 2 (tests/test_torch_elastic.py's bound; JAX's
    own splice 1 and 2 agree to the order of f32 sums, tests/test_elastic.py,
    so one JAX run, one compile, serves both)."""
    losses, extra = jax_run
    cfg, _ = _cfgs("whisper-base")
    assert extra["encoder_frames"].shape == (G, 64, 256)
    rt = ElasticRuntime(cfg, TrainConfig(**TCFG), W, W // splice, G, SEQ,
                        state=train_state_from_jax(
                            jax_state_np["whisper-base"], cfg),
                        device="cpu", extra_inputs=extra)
    hist = rt.run_steps(STEPS)
    assert [h["splice"] for h in hist] == [splice] * STEPS
    assert all(np.isfinite(h["grad_norm"]) for h in hist)
    np.testing.assert_allclose([h["loss"] for h in hist], losses, rtol=1e-5)


def test_vlm_spliced_step_matches_jax(jax_state_np):
    """One step at splice 2 from one bridged state: loss, lr and grad_norm
    at 1e-5 relative, m and v at 1e-5 of each leaf's largest entry, params
    as ``assert_first_adamw_step_close`` says."""
    arch = "llama-3.2-vision-11b"
    cfg, jcfg = _cfgs(arch)
    batch = _batch(jcfg, 1, b=4)
    state = train_state_from_jax(jax_state_np[arch], cfg)
    flags = np.array([[1, 0], [0, 1]], np.int32)
    new, metrics = build_train_step(cfg, TrainConfig(**TCFG), splice=2,
                                    with_barrier=True)(
        state, _torch(batch), torch.from_numpy(flags))
    jnew, jmetrics = jax.jit(jax_build_train_step(
        jcfg, JaxTrainConfig(**TCFG), splice=2, with_barrier=True))(
        jax.tree_util.tree_map(jnp.asarray, jax_state_np[arch]),
        jax.tree_util.tree_map(jnp.asarray, batch), jnp.asarray(flags))
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                   rtol=1e-5)
    assert metrics["barrier"].tolist() == [1, 1]
    lr = float(jmetrics["lr"])
    for part in ("m", "v"):
        for got, want in zip(tree_leaves(new["opt"][part]),
                             jax.tree_util.tree_leaves(jnew["opt"][part])):
            _close_rel(got.numpy(), want, F32_TOL)
    for got, want, m_got, m_want in zip(
            tree_leaves(new["params"]),
            jax.tree_util.tree_leaves(jnew["params"]),
            tree_leaves(new["opt"]["m"]),
            jax.tree_util.tree_leaves(jnew["opt"]["m"])):
        assert_first_adamw_step_close(got.numpy(), np.asarray(want),
                                      m_got.numpy(), np.asarray(m_want), lr)
