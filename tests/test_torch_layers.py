"""Layer parity: the port's norms, RoPE, MLPs and attention against the JAX
package's, on the CPU at f32 (rtol/atol 1e-4 unless stated).

Inputs and weights come from a numpy seed and go to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jax_attn
from repro.models import common as jax_common
from repro.models import mlp as jax_mlp
from repro_torch.models import attention as pt_attn
from repro_torch.models import common as pt_common
from repro_torch.models import mlp as pt_mlp


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(tree):
    """(torch tree, jax tree) of one numpy tree."""
    return ({k: torch.from_numpy(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               **(tol or TOL))


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "nonparametric_ln"])
def test_norms_match_jax(kind):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64, scale=3.0) + 1.0
    params = {"rmsnorm": {"scale": _rand(rng, 64)},
              "layernorm": {"scale": _rand(rng, 64), "bias": _rand(rng, 64)},
              "nonparametric_ln": None}[kind]
    pt_p, jx_p = _both(params) if params else (None, None)
    _close(pt_common.apply_norm(kind, torch.from_numpy(x), pt_p),
           jax_common.apply_norm(kind, jnp.asarray(x), jx_p))


def test_rope_is_split_half_and_matches_jax():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 64)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    got = pt_common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               10000.0)
    _close(got, jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      10000.0))
    # position 0 is the identity
    np.testing.assert_array_equal(got[0, 0].numpy(), x[0, 0])


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlp_matches_jax(kind):
    rng = np.random.default_rng(2)
    d, f = 64, 256
    params = {"wi": _rand(rng, d, f, scale=0.05),
              "wo": _rand(rng, f, d, scale=0.05)}
    if kind == "swiglu":
        params["wg"] = _rand(rng, d, f, scale=0.05)
    pt_p, jx_p = _both(params)
    x = _rand(rng, 2, 9, d)
    _close(pt_mlp.mlp_forward(pt_p, torch.from_numpy(x), kind),
           jax_mlp.mlp_forward(jx_p, jnp.asarray(x), kind))


def _attn_params(rng, d, h, kvh, hd):
    return {"wq": _rand(rng, d, h, hd, scale=0.05),
            "wk": _rand(rng, d, kvh, hd, scale=0.05),
            "wv": _rand(rng, d, kvh, hd, scale=0.05),
            "wo": _rand(rng, h, hd, d, scale=0.05)}


def test_repeat_kv_matches_jax():
    k = _rand(np.random.default_rng(3), 2, 5, 2, 8)
    _close(pt_attn._repeat_kv(torch.from_numpy(k), 6),
           jax_attn._repeat_kv(jnp.asarray(k), 6), rtol=0, atol=0)


@pytest.mark.parametrize("h,kvh,window", [(4, 4, 0), (4, 2, 0), (4, 1, 24)])
def test_attention_forward_matches_jax(h, kvh, window):
    rng = np.random.default_rng(4 + kvh + window)
    d, hd, s = 128, 32, 72
    pt_p, jx_p = _both(_attn_params(rng, d, h, kvh, hd))
    x = _rand(rng, 2, s, d)
    kw = dict(num_heads=h, num_kv_heads=kvh, rope_theta=10000.0,
              window=window)
    _close(pt_attn.attention_forward(pt_p, torch.from_numpy(x), **kw),
           jax_attn.attention_forward(jx_p, jnp.asarray(x), **kw))


def test_attention_forward_raises_off_the_slice():
    """What was off the slice until the audio and VLM families came is on
    it: cross attention (``kv=``, ragged Skv, GQA, no RoPE) and
    non-causal self-attention (RoPE on) run the plain core and agree with
    JAX's layer."""
    rng = np.random.default_rng(9)
    d, h, kvh, hd = 64, 4, 2, 16
    pt_p, jx_p = _both(_attn_params(rng, d, h, kvh, hd))
    x, src = _rand(rng, 2, 11, d), _rand(rng, 2, 29, d)
    kw = dict(num_heads=h, num_kv_heads=kvh, rope_theta=10000.0)
    _close(pt_attn.attention_forward(pt_p, torch.from_numpy(x),
                                     kv=torch.from_numpy(src), causal=False,
                                     **kw),
           jax_attn.attention_forward(jx_p, jnp.asarray(x),
                                      kv=jnp.asarray(src), causal=False,
                                      **kw))
    _close(pt_attn.attention_forward(pt_p, torch.from_numpy(x),
                                     causal=False, **kw),
           jax_attn.attention_forward(jx_p, jnp.asarray(x), causal=False,
                                      **kw))


@pytest.mark.parametrize("window,cache_len,pos", [
    (0, 16, 5),     # slot pos, masked idx <= pos
    (0, 16, 20),    # past the end: slot min(pos, cache_len - 1)
    (8, 8, 13),     # ring buffer
])
def test_decode_attention_matches_jax(window, cache_len, pos):
    rng = np.random.default_rng(5 + pos)
    d, h, kvh, hd, b = 64, 4, 2, 16, 2
    pt_p, jx_p = _both(_attn_params(rng, d, h, kvh, hd))
    x = _rand(rng, b, 1, d)
    cache = {"k": _rand(rng, b, cache_len, kvh, hd),
             "v": _rand(rng, b, cache_len, kvh, hd)}
    kw = dict(num_heads=h, num_kv_heads=kvh, rope_theta=10000.0,
              window=window)
    pt_cache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, got_cache = pt_attn.decode_attention(pt_p, torch.from_numpy(x),
                                              pt_cache, pos, **kw)
    want, want_cache = jax_attn.decode_attention(
        jx_p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(pos, jnp.int32), **kw)
    _close(got, want)
    for name in ("k", "v"):
        _close(got_cache[name], want_cache[name])
