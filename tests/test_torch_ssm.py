"""The port's SSD scan and Mamba2 block against the JAX package's, on the
CPU at f32.

On the CPU the port's wrapper takes the kernel's plain PyTorch version (the
CUDA kernel runs only on a card); the JAX side runs the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it.  The same numpy
inputs go to both.  The card-only comparison of the CUDA kernel with its
plain version is in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.kernels.ssd_scan.ops import ssd_chunked_pallas
from repro.kernels.ssd_scan.ssd import ssd_intra_chunk as jax_ssd_intra_chunk
from repro.models import ssm as jax_ssm
from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_ref,
                                              ssd_intra_chunk_ref,
                                              ssd_sequential_ref)
from repro_torch.kernels.ssd_scan.ssd import ssd_intra_chunk
from repro_torch.models import ssm as pt_ssm


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)


def _softplus(v):
    return np.logaddexp(v, 0.0).astype(np.float32)


def _ssd_inputs(seed, bs, l, h, p, n):
    """x, dt, a, b, c in numpy, drawn as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((bs, l, h, p), dtype=f32)
    dt = _softplus(rng.standard_normal((bs, l, h), dtype=f32))
    a = -np.exp(0.1 * rng.standard_normal(h, dtype=f32)).astype(f32)
    b = rng.standard_normal((bs, l, n), dtype=f32)
    c = rng.standard_normal((bs, l, n), dtype=f32)
    return x, dt, a, b, c


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# the four shapes of test_kernels.py::test_ssd_kernel_matches_oracles
SHAPES = [
    (2, 128, 4, 32, 16, 32),
    (1, 200, 2, 64, 32, 64),      # ragged length
    (2, 96, 8, 16, 64, 32),
    (1, 64, 1, 128, 128, 64),
]


@pytest.mark.parametrize("bs,l,h,p,n,chunk", SHAPES)
def test_ssd_intra_chunk_ref_matches_pallas(bs, l, h, p, n, chunk):
    """The plain version against the Pallas kernel body, on the kernel's
    (BC, Q, ...) layout."""
    x, dt, a, b, c = _ssd_inputs(l + n, bs, l - l % chunk, h, p, n)
    bc = bs * (x.shape[1] // chunk)
    x = x.reshape(bc, chunk, h, p)
    dt = dt.reshape(bc, chunk, h)
    b, c = b.reshape(bc, chunk, n), c.reshape(bc, chunk, n)
    got = ssd_intra_chunk_ref(*_torch(x, dt, a, b, c))
    want = jax_ssd_intra_chunk(*_jax(x, dt, a, b, c), interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _close(g, w)


@pytest.mark.parametrize("bs,l,h,p,n,chunk", SHAPES)
def test_ssd_chunked_matches_pallas_and_recurrence(bs, l, h, p, n, chunk):
    x, dt, a, b, c = _ssd_inputs(bs * 1000 + l, bs, l, h, p, n)
    launches = ssd_intra_chunk.launches
    y, final = ssd_chunked(*_torch(x, dt, a, b, c), chunk)
    assert ssd_intra_chunk.launches == launches  # no kernel on the CPU
    jy, jfinal = ssd_chunked_pallas(*_jax(x, dt, a, b, c), chunk)
    assert y.shape == (bs, l, h, p) and final.shape == (bs, h, p, n)
    _close(y, jy)
    _close(final, jfinal)
    # against the O(L) recurrence: test_kernels.py's 1e-3
    y_seq, s_seq = ssd_sequential_ref(*_torch(x, dt, a, b, c))
    _close(y, y_seq.numpy(), rtol=1e-3, atol=1e-3)
    _close(final, s_seq.numpy(), rtol=1e-3, atol=1e-3)
    y_ref, s_ref = ssd_chunked_ref(*_torch(x, dt, a, b, c), chunk)
    _close(y, y_ref.numpy())
    _close(final, s_ref.numpy())


def test_ssd_initial_state_continuation():
    """Two calls with the state carried == one call (prefill/decode
    continuity), as test_kernels.py::test_ssd_initial_state_continuation."""
    x, dt, a, b, c = _torch(*_ssd_inputs(5, 1, 128, 2, 32, 16))
    y_full, s_full = ssd_chunked(x, dt, a, b, c, 32)
    half = 64
    y1, s1 = ssd_chunked(x[:, :half], dt[:, :half], a, b[:, :half],
                         c[:, :half], 32)
    y2, s2 = ssd_chunked(x[:, half:], dt[:, half:], a, b[:, half:],
                         c[:, half:], 32, initial_state=s1)
    _close(torch.cat([y1, y2], 1), y_full.numpy())
    _close(s2, s_full.numpy())


def test_ssd_chunked_rounds_y_to_x_dtype():
    x, dt, a, b, c = _torch(*_ssd_inputs(6, 1, 40, 2, 16, 16))
    y, final = ssd_chunked(x.bfloat16(), dt, a, b.bfloat16(), c.bfloat16(),
                           32)
    assert y.dtype == torch.bfloat16 and final.dtype == torch.float32


def test_ssd_intra_chunk_rejects_what_the_kernel_does_not_take():
    x, dt, a, b, c = _torch(*_ssd_inputs(7, 1, 32, 2, 16, 16))
    before = ssd_intra_chunk.launches
    with pytest.raises(ValueError, match="CUDA"):
        ssd_intra_chunk(x, dt[..., 0], a, b, c)
    assert ssd_intra_chunk.launches == before


# ------------------------------------------------------------ Mamba2 block
D_MODEL = 64
CFG = dict(state_dim=16, head_dim=16, expand=2, chunk_size=16, conv_width=4)


def _block_params(seed):
    """One Mamba2 block's weights, in numpy, at the shapes init_ssm makes;
    A_log, D and dt_bias away from their init values."""
    rng = np.random.default_rng(seed)
    d_in, n = CFG["expand"] * D_MODEL, CFG["state_dim"]
    h = d_in // CFG["head_dim"]
    f32 = np.float32

    def rand(*shape, scale):
        return (scale * rng.standard_normal(shape)).astype(f32)

    return {
        "in_proj": rand(D_MODEL, 2 * d_in + 2 * n + h, scale=0.1),
        "conv_w": rand(CFG["conv_width"], d_in + 2 * n, scale=0.3),
        "conv_b": rand(d_in + 2 * n, scale=0.1),
        "A_log": rand(h, scale=0.5),
        "D": 1.0 + rand(h, scale=0.1),
        "dt_bias": -2.0 + rand(h, scale=0.5),
        "norm_scale": 1.0 + rand(d_in, scale=0.1),
        "out_proj": rand(d_in, D_MODEL, scale=0.1),
    }


def _block_both(seed):
    params = _block_params(seed)
    return ({k: torch.from_numpy(v) for k, v in params.items()},
            {k: jnp.asarray(v) for k, v in params.items()})


@pytest.mark.parametrize("l", [48, 37])  # whole chunks, and ragged
def test_ssm_forward_matches_jax(l):
    pt_params, jax_params = _block_both(0)
    x = np.random.default_rng(1).standard_normal((2, l, D_MODEL)).astype(
        np.float32)
    got = pt_ssm.ssm_forward(pt_params, torch.from_numpy(x), SSMConfig(**CFG))
    want = jax_ssm.ssm_forward(jax_params, jnp.asarray(x),
                               JaxSSMConfig(**CFG))
    assert got.shape == (2, l, D_MODEL)
    _close(got, want)


def test_ssm_decode_step_matches_jax():
    pt_params, jax_params = _block_both(2)
    rng = np.random.default_rng(3)
    d_in, n = CFG["expand"] * D_MODEL, CFG["state_dim"]
    h = d_in // CFG["head_dim"]
    state = {"conv": rng.standard_normal(
                 (2, CFG["conv_width"] - 1, d_in + 2 * n)).astype(np.float32),
             "ssm": rng.standard_normal(
                 (2, h, CFG["head_dim"], n)).astype(np.float32)}
    x = rng.standard_normal((2, 1, D_MODEL)).astype(np.float32)
    got, new = pt_ssm.ssm_decode_step(
        pt_params, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in state.items()}, SSMConfig(**CFG))
    want, jnew = jax_ssm.ssm_decode_step(
        jax_params, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
        JaxSSMConfig(**CFG))
    _close(got, want)
    for key in ("conv", "ssm"):
        assert tuple(new[key].shape) == jnew[key].shape
        _close(new[key], jnew[key])


def test_ssm_prefill_state_continues_into_decode():
    """The block's prefill state, stepped by one decode token, gives the
    block's output at that token over the longer prompt."""
    pt_params, _ = _block_both(4)
    cfg = SSMConfig(**CFG)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 33, D_MODEL)).astype(np.float32))
    _, state = pt_ssm.ssm_prefill(pt_params, x[:, :32], cfg)
    assert state["conv"].shape == (2, CFG["conv_width"] - 1,
                                   CFG["expand"] * D_MODEL + 2 * CFG["state_dim"])
    step, _ = pt_ssm.ssm_decode_step(pt_params, x[:, 32:], state, cfg)
    full = pt_ssm.ssm_forward(pt_params, x, cfg)
    _close(step[:, 0], full[:, 32].numpy(), rtol=2e-3, atol=2e-3)
