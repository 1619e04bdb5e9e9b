"""Model and engine parity for the SSM and hybrid families: the port's
mamba2-130m and zamba2-1.2b serving paths against the JAX package's, on the
CPU at their smoke sizes (2 layers, d 256, 16 SSD heads of 32, state 16,
chunk 32, vocab 512; zamba2 with 4 attention heads of 64, one shared block
every 2 layers and a window of 128).  zamba2 also runs at 5 layers (two
groups and a tail layer, the layout of the full model's 38 = 6 x 6 + 2).

The JAX package draws the weights; the bridge moves them into the port bit
for bit; prompts come from a numpy seed.  zamba2's prompt of 160 runs past
its window of 128, so its KV cache is a ring.  f32 runs compare at
rtol/atol 1e-4; the bf16 run at a looser bound stated where it is used.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step_fn as jax_decode_step_fn
from repro.models import init_decode_state as jax_init_decode_state
from repro.models import init_params as jax_init_params
from repro.models import prefill_fn as jax_prefill_fn
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import (decode_step_fn, init_decode_state,
                                init_params, prefill_fn)
from repro_torch.models.ssm import F32_LEAVES
from repro_torch.serving.engine import ServingEngine


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)
B = 2
# name -> (arch, layers or None for the smoke config's, prompt length)
CASES = {
    "mamba2": ("mamba2-130m", None, 48),
    "zamba2": ("zamba2-1.2b", None, 160),
    "zamba2-5l": ("zamba2-1.2b", 5, 160),
}


def _cfgs(case, dtype="float32"):
    """The same smoke config from both packages."""
    arch, layers, _ = CASES[case]
    changes = dict(dtype=dtype)
    if layers:
        changes["num_layers"] = layers
    return (dataclasses.replace(get_smoke_config(arch), **changes),
            dataclasses.replace(jax_smoke_config(arch), **changes))


_PARAMS = {}


def _jax_params_np(case):
    """The JAX package's weights for ``case``, as numpy, drawn once."""
    if case not in _PARAMS:
        _, jcfg = _cfgs(case)
        params = jax_init_params(jcfg, jax.random.PRNGKey(0))
        _PARAMS[case] = jax.tree_util.tree_map(np.asarray, params)
    return _PARAMS[case]


def _tokens(case):
    s = CASES[case][2]
    return np.random.default_rng(0).integers(0, 512, (B, s + 1),
                                             dtype=np.int32)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from _leaves(val, path + (key,))
    else:
        yield path, tree


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


def _sorted(t):  # jax.vmap hands its dicts back in sorted-key order
    if isinstance(t, dict):
        return {k: _sorted(t[k]) for k in sorted(t)}
    return t


@pytest.mark.parametrize("case", ["mamba2", "zamba2"])
def test_bridge_round_trip_is_bit_exact_and_keeps_f32_leaves(case):
    cfg, _ = _cfgs(case)
    jp = _jax_params_np(case)
    pt = params_from_jax(jp, cfg, device="cpu")
    _assert_same_tree(params_to_numpy(pt), jp, exact=True)
    assert ("shared_attn" in pt) == (cfg.arch_type == "hybrid")
    bf = params_from_jax(jp, cfg, device="cpu", dtype=torch.bfloat16)
    for path, leaf in _leaves(bf):
        want = torch.float32 if path[-1] in F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, path
    for name in F32_LEAVES:  # still bit for bit
        np.testing.assert_array_equal(bf["blocks"]["ssm"][name].numpy(),
                                      jp["blocks"]["ssm"][name])


@pytest.mark.parametrize("case", ["mamba2", "zamba2"])
def test_port_init_params_has_the_jax_tree(case):
    cfg, _ = _cfgs(case)
    ours = params_to_numpy(init_params(cfg, 0, device="cpu"))
    _assert_same_tree(_sorted(ours), _sorted(_jax_params_np(case)),
                      exact=False)
    bf = init_params(cfg, 0, device="cpu", dtype=torch.bfloat16)
    for path, leaf in _leaves(bf):
        want = torch.float32 if path[-1] in F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, path


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    cfg, jcfg = _cfgs(case)
    jp = _jax_params_np(case)
    params = params_from_jax(jp, cfg, device="cpu")
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    tokens = _tokens(case)
    s = tokens.shape[1] - 1
    prompt = tokens[:, :s]

    logits, state = prefill_fn(params, {"tokens": torch.from_numpy(prompt)},
                               cfg, cache_len=s + 4)
    jlogits, jstate = jax.jit(
        lambda p, t: jax_prefill_fn(p, {"tokens": t}, jcfg, cache_len=s + 4))(
        jparams, jnp.asarray(prompt))
    assert logits.dtype == torch.float32 and logits.shape == (B, 512)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert state["pos"] == int(jstate["pos"]) == s
    assert sorted(state) == sorted(jstate)
    for group in ("ssm", "kv"):
        if group not in jstate:
            continue
        assert list(state[group]) == list(jstate[group])
        for name in state[group]:
            got, want = state[group][name], jstate[group][name]
            assert got.shape == want.shape, (group, name)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    nxt = tokens[:, s]
    dlogits, state = decode_step_fn(params, state, torch.from_numpy(nxt), cfg)
    jdlogits, _ = jax.jit(lambda p, st, t: jax_decode_step_fn(p, st, t, jcfg))(
        jparams, jstate, jnp.asarray(nxt))
    np.testing.assert_allclose(dlogits.numpy(), np.asarray(jdlogits), **TOL)
    assert state["pos"] == s + 1

    # decode-vs-prefill consistency (tests/test_decode_consistency.py)
    ref, _ = prefill_fn(params, {"tokens": torch.from_numpy(tokens)}, cfg)
    np.testing.assert_allclose(dlogits.numpy(), ref.numpy(),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_decode_from_a_fresh_state_matches_jax(dtype, tol):
    """Two decode steps from ``init_decode_state``, whose conv state is f32
    as in JAX: at bf16 the conv then runs in f32, as JAX promotes it."""
    cfg, jcfg = _cfgs("zamba2", dtype)
    jp = _jax_params_np("zamba2")
    params = params_from_jax(jp, cfg, device="cpu",
                             dtype=getattr(torch, dtype))
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    tokens = _tokens("zamba2")[:, :2]
    state = init_decode_state(cfg, B, 8, device="cpu",
                              dtype=getattr(torch, dtype))
    jstate = jax_init_decode_state(jcfg, B, 8, dtype=jnp.dtype(dtype))
    step = jax.jit(lambda p, st, t: jax_decode_step_fn(p, st, t, jcfg))
    for i in range(2):
        logits, state = decode_step_fn(params, state,
                                       torch.from_numpy(tokens[:, i]), cfg)
        jlogits, jstate = step(jparams, jstate, jnp.asarray(tokens[:, i]))
        # f32: 1e-4; bf16: the olmo bf16 test's 5e-2 on O(1) logits
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["mamba2", "zamba2"])
def test_bf16_prefill_matches_jax(case):
    cfg, jcfg = _cfgs(case, "bfloat16")
    jp = _jax_params_np(case)
    # the port stores bf16 once (the SSM's f32 leaves stay f32); JAX keeps
    # f32 and casts at each use
    params = params_from_jax(jp, cfg, device="cpu", dtype=torch.bfloat16)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    prompt = _tokens(case)[:, :-1]
    logits, state = prefill_fn(params, {"tokens": torch.from_numpy(prompt)},
                               cfg)
    jlogits, jstate = jax.jit(
        lambda p, t: jax_prefill_fn(p, {"tokens": t}, jcfg))(
        jparams, jnp.asarray(prompt))
    assert state["ssm"]["conv"].dtype == torch.bfloat16
    assert state["ssm"]["ssm"].dtype == torch.float32
    # bf16 activations round at other places in the two frameworks (8
    # bits of mantissa, 2 layers); logits here are O(1), so 5e-2 absolute,
    # the bound of the olmo bf16 test
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=5e-2)


@pytest.mark.parametrize("case", ["mamba2", "zamba2"])
def test_engine_greedy_tokens_match_jax(case):
    cfg, jcfg = _cfgs(case)
    jp = _jax_params_np(case)
    prompt = _tokens(case)[:, :-1]
    ours = ServingEngine(cfg, params=params_from_jax(jp, cfg),
                         device="cpu").generate(prompt, max_new_tokens=8)
    want = JaxServingEngine(
        jcfg, params=jax.tree_util.tree_map(jnp.asarray, jp)).generate(
        jnp.asarray(prompt), max_new_tokens=8)
    assert ours.dtype == torch.int32 and ours.shape == (B, 8)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
