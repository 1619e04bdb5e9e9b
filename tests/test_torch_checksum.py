"""The port's content fingerprint (``repro_torch.kernels.checksum``) against
the JAX package's, on the CPU: the words of ``_as_words``, the digest of
``fingerprint`` (the JAX side runs its Pallas kernel in interpret mode)
and the strings of ``digest_hex``, bit for bit, over the shapes and dtypes
of ``tests/test_kernels.py`` and more; the kernel tests' sensitivity and
equal-content properties; and 64-bit inputs, which JAX with 64-bit types
off never holds, against a numpy oracle.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.checksum import ops as jax_ops
from repro.kernels.checksum.ref import fingerprint_u32_ref as jax_ref
from repro_torch.kernels.checksum.fingerprint import (BLOCK_WORDS, P1, P2, P3,
                                                       P4, fingerprint_u32,
                                                       padded_words)
from repro_torch.kernels.checksum.ops import _as_words, digest_hex, fingerprint
from repro_torch.kernels.checksum.ref import fingerprint_u32_ref


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


M32 = np.uint64(0xFFFFFFFF)

# test_kernels.py:17-20, then f16, int8, bool, int16 (the float32-values
# branch) and lengths that are not a multiple of the 32,768-word block
CASES = [
    ((1000,), np.float32), ((64, 128), ml_dtypes.bfloat16),
    ((7, 11, 13), np.int32), ((100_000,), np.float32),
    ((3, 5), np.float32), ((256, 128), np.uint8),
    ((33, 7), np.float16), ((77,), np.int8), ((50,), np.bool_),
    ((9, 3), np.int16), ((40_000,), np.float32), ((32_769,), np.uint32),
]


def _draw(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if dtype in (np.bool_,):
        return rng.integers(0, 2, shape).astype(bool)
    if np.dtype(dtype).kind in "iu":
        return rng.integers(0, 100, shape).astype(dtype)
    # negative values too: a sign-extended 16-bit word would show
    return rng.standard_normal(shape).astype(dtype)


def _tensor(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(x.copy())


def _np_digest(words: np.ndarray) -> np.ndarray:
    """The digest of 1-D uint32 words, padded here, in numpy uint64."""
    pad = (-words.size) % BLOCK_WORDS
    x = np.concatenate([words, np.zeros(pad, np.uint32)]).astype(np.uint64)
    pos = np.arange(x.size, dtype=np.uint64)
    w = (pos * np.uint64(P1) + np.uint64(P2)) & M32
    lanes = [x * w,
             (x ^ np.uint64(P3)) * (w ^ np.uint64(P4)),
             ((x * x + np.uint64(P4)) & M32) * w,
             ((x + pos) & M32) * ((pos * np.uint64(P3) + np.uint64(P1)) & M32)]
    return np.array([int((t & M32).sum() & M32) for t in lanes], np.uint32)


@pytest.mark.parametrize("shape,dtype", CASES)
def test_words_and_digest_match_jax(shape, dtype):
    x = _draw(shape, dtype)
    jx = jnp.asarray(x)
    t = _tensor(x)
    want_words = np.asarray(jax_ops._as_words(jx))
    got_words = _as_words(t)
    assert got_words.dtype == torch.uint32
    np.testing.assert_array_equal(got_words.numpy(), want_words)
    want = np.asarray(jax_ops.fingerprint(jx))
    got = fingerprint(t)
    assert got.dtype == torch.uint32 and got.shape == (4,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        fingerprint_u32_ref(got_words).numpy(),
        np.asarray(jax_ref(jnp.asarray(want_words))))
    np.testing.assert_array_equal(want, _np_digest(want_words.reshape(-1)))


@pytest.mark.parametrize("shape,dtype", [
    ((1000,), np.float32), ((64, 128), ml_dtypes.bfloat16),
    ((33, 7), np.float16), ((7, 11, 13), np.int32), ((50,), np.bool_)])
def test_digest_hex_matches_jax(shape, dtype):
    x = _draw(shape, dtype, seed=1)
    want = jax_ops.digest_hex(x)
    assert len(want) == 32
    assert digest_hex(x, device="cpu") == want
    assert digest_hex(_tensor(x)) == want


def test_fingerprint_sensitivity():
    """test_kernels.py: one changed element and a permutation change the
    digest."""
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(4096)
                         .astype(np.float32))
    base = fingerprint(x)
    for i in (0, 1000, 4095):
        mod = x.clone()
        mod[i] += 1e-6
        assert not torch.equal(fingerprint(mod), base)
    assert not torch.equal(fingerprint(x.flip(0)), base)


def test_fingerprint_equal_content_equal_digest():
    """test_kernels.py: a copy, and a strided view of equal content, digest
    the same."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((512, 128))
                         .astype(np.float32))
    assert torch.equal(fingerprint(x), fingerprint(x.clone()))
    assert torch.equal(fingerprint(x.T.contiguous().T), fingerprint(x))


@pytest.mark.parametrize("dtype", [np.int64, np.float64, np.uint64])
def test_64_bit_inputs_against_numpy(dtype):
    """JAX with 64-bit types off never holds them.  The port's fingerprint
    of a 64-bit tensor digests two little-endian words per element;
    digest_hex of a numpy 64-bit array narrows to 32 bits first, as
    ``jnp.asarray`` does, and then equals JAX's."""
    x = np.abs(np.random.default_rng(4).standard_normal(3000) * 1e6
               ).astype(dtype)
    if dtype == np.int64:
        x[:3] = [-1, 2 ** 40, -(2 ** 35)]   # high words that matter
    if dtype == np.uint64:
        x[:2] = [2 ** 63 + 5, 2 ** 32 + 7]
    t = torch.from_numpy(x.copy()) if dtype != np.uint64 else \
        torch.from_numpy(x.view(np.int64).copy())
    np.testing.assert_array_equal(fingerprint(t).numpy(),
                                  _np_digest(x.view(np.uint32)))
    narrow = x.astype({np.int64: np.int32, np.float64: np.float32,
                       np.uint64: np.uint32}[dtype])
    got = digest_hex(x, device="cpu")
    assert got == jax_ops.digest_hex(x)
    assert got == "".join(f"{v:08x}" for v in
                          _np_digest(narrow.view(np.uint32)))


def test_padding_counts_and_empty_digest():
    """Zero padding adds to lanes 1-3, so a buffer and the same buffer with
    its padding written out as zero words agree only because the digest
    covers the padded length; the empty tensor has the zero digest."""
    x = torch.arange(1, 101, dtype=torch.int32)
    padded = torch.cat([x, torch.zeros(BLOCK_WORDS - 100, dtype=torch.int32)])
    assert torch.equal(fingerprint(x), fingerprint(padded))
    zeros = fingerprint(torch.zeros(5, dtype=torch.int32)).numpy()
    assert zeros[0] == 0 and (zeros[1:] != 0).all()
    assert fingerprint(torch.zeros(0)).tolist() == [0, 0, 0, 0]
    np.testing.assert_array_equal(fingerprint(torch.zeros(0)).numpy(),
                                  _np_digest(np.zeros(0, np.uint32)))


def test_ref_wraps_past_2_32_products():
    """All-ones words: every product overflows 32 bits (and x * x + P4
    wraps), the cases int64 arithmetic must mask right."""
    words = torch.full((BLOCK_WORDS,), -1, dtype=torch.int32)
    np.testing.assert_array_equal(
        fingerprint(words).numpy(),
        _np_digest(np.full(BLOCK_WORDS, 0xFFFFFFFF, np.uint32)))


def test_kernel_wrapper_refuses_cpu_tensors():
    before = fingerprint_u32.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        fingerprint_u32(torch.zeros(BLOCK_WORDS, dtype=torch.int32))
    assert fingerprint_u32.launches == before
    assert padded_words(0) == 0
    assert padded_words(1) == BLOCK_WORDS
    assert padded_words(BLOCK_WORDS + 1) == 2 * BLOCK_WORDS


def test_digest_hex_of_a_host_array_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        digest_hex(np.zeros(4, np.float32))
