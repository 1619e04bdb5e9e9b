"""Model and engine parity: the port's olmo-1b serving path against the JAX
package's, on the CPU at the olmo smoke size (2 layers, d 256, 4 heads of
64, vocab 512).

The JAX package draws the weights (``repro.models.init_params``); the
bridge moves them into the port bit for bit; prompts come from a numpy
seed.  f32 runs compare at rtol/atol 1e-4; the bf16 run at a looser bound
stated where it is used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step_fn as jax_decode_step_fn
from repro.models import init_params as jax_init_params
from repro.models import prefill_fn as jax_prefill_fn
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import decode_step_fn, init_params, prefill_fn
from repro_torch.serving.engine import ServingEngine


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
B, S = 2, 48


def _cfgs(dtype="float32"):
    """The same olmo smoke config from both packages."""
    return (dataclasses.replace(get_smoke_config("olmo-1b"), dtype=dtype),
            dataclasses.replace(jax_smoke_config("olmo-1b"), dtype=dtype))


@pytest.fixture(scope="module")
def jax_params_np():
    _, jcfg = _cfgs()
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (B, S + 1),
                                             dtype=np.int32)


def _assert_same_tree(a, b, exact):
    assert (a is None) == (b is None)
    if a is None:
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)  # keys and order
        for key in a:
            _assert_same_tree(a[key], b[key], exact)
        return
    assert a.shape == b.shape and a.dtype == b.dtype
    if exact:
        np.testing.assert_array_equal(a, b)


def test_bridge_round_trip_is_bit_exact(jax_params_np):
    cfg, _ = _cfgs()
    pt = params_from_jax(jax_params_np, cfg, device="cpu")
    assert pt["final_norm"] is None and pt["blocks"]["ln1"] is None
    assert tuple(pt["blocks"]["attn"]["wq"].shape) == (2, 256, 4, 64)
    _assert_same_tree(params_to_numpy(pt), jax_params_np, exact=True)


def test_port_init_params_has_the_jax_tree(jax_params_np):
    cfg, _ = _cfgs()
    ours = params_to_numpy(init_params(cfg, 0, device="cpu"))

    def sort(t):  # jax.vmap hands its dicts back in sorted-key order
        if isinstance(t, dict):
            return {k: sort(t[k]) for k in sorted(t)}
        return t

    _assert_same_tree(sort(ours), sort(jax_params_np), exact=False)


def test_prefill_and_decode_match_jax(jax_params_np, tokens):
    cfg, jcfg = _cfgs()
    params = params_from_jax(jax_params_np, cfg, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_params_np)
    prompt = tokens[:, :S]

    logits, state = prefill_fn(params, {"tokens": torch.from_numpy(prompt)},
                               cfg, cache_len=S + 4)
    jlogits, jstate = jax.jit(
        lambda p, t: jax_prefill_fn(p, {"tokens": t}, jcfg, cache_len=S + 4))(
        jparams, jnp.asarray(prompt))
    assert logits.dtype == torch.float32 and logits.shape == (B, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert state["pos"] == int(jstate["pos"]) == S
    for name in ("k", "v"):  # zero-padded to cache_len, as JAX pads
        assert state["kv"][name].shape == jstate["kv"][name].shape
        np.testing.assert_allclose(state["kv"][name].numpy(),
                                   np.asarray(jstate["kv"][name]), **TOL)

    nxt = tokens[:, S]
    dlogits, state = decode_step_fn(params, state, torch.from_numpy(nxt), cfg)
    jdlogits, _ = jax.jit(lambda p, s, t: jax_decode_step_fn(p, s, t, jcfg))(
        jparams, jstate, jnp.asarray(nxt))
    np.testing.assert_allclose(dlogits.numpy(), np.asarray(jdlogits), **TOL)
    assert state["pos"] == S + 1

    # decode-vs-prefill consistency (tests/test_decode_consistency.py)
    ref, _ = prefill_fn(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    np.testing.assert_allclose(dlogits.numpy(), ref.numpy(),
                               rtol=2e-3, atol=2e-3)


def test_bf16_prefill_matches_jax(jax_params_np, tokens):
    cfg, jcfg = _cfgs("bfloat16")
    # the port stores bf16 once; JAX keeps f32 and casts at each use
    params = params_from_jax(jax_params_np, cfg, device="cpu",
                             dtype=torch.bfloat16)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_params_np)
    prompt = tokens[:, :S]
    logits, _ = prefill_fn(params, {"tokens": torch.from_numpy(prompt)}, cfg)
    jlogits, _ = jax.jit(lambda p, t: jax_prefill_fn(p, {"tokens": t}, jcfg))(
        jparams, jnp.asarray(prompt))
    # bf16 activations round at other places in the two frameworks (8
    # bits of mantissa, 2 layers); logits here are O(1), so 5e-2 absolute
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=5e-2)


def test_engine_greedy_tokens_match_jax(jax_params_np, tokens):
    cfg, jcfg = _cfgs()
    prompt = tokens[:, :S]
    ours = ServingEngine(cfg, params=params_from_jax(jax_params_np, cfg),
                         device="cpu").generate(prompt, max_new_tokens=8)
    jax_params = jax.tree_util.tree_map(jnp.asarray, jax_params_np)
    want = JaxServingEngine(jcfg, params=jax_params).generate(
        jnp.asarray(prompt), max_new_tokens=8)
    assert ours.dtype == torch.int32 and ours.shape == (B, 8)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
