"""h2o-danube-3-4b served past its sliding window: the port against the
JAX package on the CPU at the smoke size (2 layers, d_model 256, 4 query
heads and 1 KV head of 64, window 128, vocab 512), f32.

A prompt of 160 tokens, 32 past the window, so prefill writes the last 128
positions into the KV cache in ring layout (position p at slot p % 128)
and its attention masks both ends of each row; then 40 greedy tokens,
each decode step writing slot pos % 128 over the oldest position and
masking the ring by age.  Prefill logits, the ring cache after prefill
and after the 40 steps, and the greedy tokens are held against JAX's;
decode against the port's own prefill of the longer prompt past the wrap.
The weights are drawn from a numpy seed and cross to both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step_fn as jax_decode_step_fn
from repro.models import prefill_fn as jax_prefill_fn
from repro_torch.bridge import params_from_jax, params_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models import decode_step_fn, init_params, prefill_fn


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "h2o-danube-3-4b"
B, S, NEW = 2, 160, 40
# f32 on both sides, summed in other orders (tests/test_torch_model.py)
TOL = dict(rtol=1e-4, atol=1e-4)
# decode against prefill: one position's logits through two orders of
# work (tests/test_torch_model.py's decode-vs-prefill bound)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)


def test_ring_cache_and_greedy_tokens_past_the_window_match_jax():
    cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    assert cfg.sliding_window == 128 < S
    rng = np.random.default_rng(0)
    params_np = _draw(params_to_numpy(init_params(cfg, 0, device="cpu")), rng)
    params = params_from_jax(params_np, cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    prompt = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)

    logits, state = prefill_fn(params, {"tokens": torch.from_numpy(prompt)},
                               cfg, cache_len=S + NEW)
    jlogits, jstate = jax.jit(lambda p, t: jax_prefill_fn(
        p, {"tokens": t}, jcfg, cache_len=S + NEW))(jparams,
                                                    jnp.asarray(prompt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert state["kv"]["k"].shape == (2, B, 128, 1, 64)
    _assert_cache_close(state, jstate)

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
    toks = torch.stack(toks, 1)
    np.testing.assert_array_equal(toks.numpy(),
                                  np.asarray(jnp.stack(jtoks, 1)))
    assert state["pos"] == int(jstate["pos"]) == S + NEW - 1
    _assert_cache_close(state, jstate)

    # decode past the wrap against prefill of the whole sequence: the last
    # step's logits are those of the prompt and the first 39 new tokens
    full = np.concatenate([prompt, toks[:, :-1].numpy()], axis=1)
    ref, ref_state = prefill_fn(params, {"tokens": torch.from_numpy(full)},
                                cfg)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), **DECODE_TOL)
    for name in ("k", "v"):  # the same ring, slot for slot
        np.testing.assert_allclose(state["kv"][name].numpy(),
                                   ref_state["kv"][name].numpy(),
                                   **DECODE_TOL)


def _assert_cache_close(state, jstate):
    for name in ("k", "v"):
        got, want = state["kv"][name], np.asarray(jstate["kv"][name])
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def _draw(tree, rng, key=""):
    """A tree of the same shapes drawn from ``rng``: norm scales
    1 + 0.1 N(0, 1), weights 0.02 N(0, 1)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _draw(v, rng, k) for k, v in tree.items()}
    shift, scale = (1.0, 0.1) if key == "scale" else (0.0, 0.02)
    return (shift + scale * rng.standard_normal(tree.shape)).astype(
        np.float32)
