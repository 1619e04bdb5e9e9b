"""The port's ``swa_attention`` against the JAX package's, on the CPU.

On the CPU the port's wrapper takes its plain PyTorch version (the CUDA
kernel runs only on a card); the JAX side runs the Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` runs it.  The same numpy
inputs go to both.  The card-only comparison of the CUDA kernel with the
plain version is in ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.swa_attention.ops import swa_attention as jax_swa_attention
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.kernels.swa_attention.swa import check_head_dim, swa_flash


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]


# the five shapes of test_kernels.py::test_swa_attention_matches_oracle,
# then the head dims of h2o-danube-3-4b (120) and paper-gpt2-1.8b (80)
# with a window and a ragged S
@pytest.mark.parametrize("b,s,h,d,w", [
    (2, 256, 4, 64, 0),
    (1, 384, 2, 128, 128),
    (2, 200, 3, 64, 96),
    (1, 512, 2, 64, 0),
    (1, 128, 1, 32, 48),
    (2, 200, 3, 80, 96),
    (1, 200, 2, 120, 0),
    (1, 256, 2, 120, 64),
])
def test_swa_attention_matches_jax(b, s, h, d, w):
    q, k, v = _qkv(b * 1000 + s + w, (b, s, h, d))
    launches = swa_flash.launches
    got = swa_attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), window=w)
    want = jax_swa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             window=w)
    assert got.shape == (b, s, h, d) and got.dtype == torch.float32
    # f32 on both sides; the sums run in another order (test_kernels' 2e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    assert swa_flash.launches == launches  # no kernel on the CPU


def test_swa_attention_bf16_matches_jax():
    q, k, v = _qkv(7, (1, 256, 2, 64))
    to_t = lambda a: torch.from_numpy(a).to(torch.bfloat16)  # noqa: E731
    to_j = lambda a: jnp.asarray(a).astype(jnp.bfloat16)     # noqa: E731
    got = swa_attention(to_t(q), to_t(k), to_t(v), window=64)
    want = jax_swa_attention(to_j(q), to_j(k), to_j(v), window=64)
    assert got.dtype == torch.bfloat16
    # both round their f32 result to bf16 (8 bits of mantissa): 2e-2, the
    # bound of test_kernels.py::test_swa_attention_bf16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_swa_flash_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 8, 2, 64)
    before = swa_flash.launches
    with pytest.raises(ValueError, match="CUDA"):
        swa_flash(q, q, q, window=0)
    assert swa_flash.launches == before


def test_head_dim_rule_takes_every_multiple_of_8_up_to_128():
    """The kernel's head-dim rule, as a function (a CPU tensor given to
    ``swa_flash`` raises on "CUDA" first): 8, 16, ..., 128 pass, among them
    80 (paper-gpt2-1.8b) and 120 (h2o-danube-3-4b); others raise."""
    for d in range(8, 129, 8):
        check_head_dim(d)
    for d in (0, 4, 76, 100, 130, 136, 256):
        with pytest.raises(ValueError, match="multiple of 8"):
            check_head_dim(d)
