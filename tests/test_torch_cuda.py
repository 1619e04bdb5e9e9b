"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on a card.  Marked ``cuda``: where there is no card each test
skips (the kernel has no CPU mode).  This file imports no JAX, so it runs
on a machine without it; there, skip the JAX-importing ``conftest.py``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import (ssd_intra_chunk_ref,
                                              ssd_sequential_ref)
from repro_torch.kernels.ssd_scan.ssd import ssd_intra_chunk
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.kernels.swa_attention.ref import swa_attention_ref
from repro_torch.kernels.swa_attention.swa import swa_flash


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,w,dtype,tol", [
    # bf16: the kernel and the plain version each round an f32 result to
    # bf16 once, so they may differ by one bf16 ulp: 2**-7 relative
    (4, 512, 16, 128, 0, torch.bfloat16, 2 ** -7),
    # f32: the same f32 arithmetic summed in another order
    (4, 512, 16, 128, 0, torch.float32, 2e-5),
    (2, 200, 3, 64, 96, torch.float32, 2e-5),
    (1, 128, 1, 32, 48, torch.float32, 2e-5),
])
def test_swa_flash_matches_plain_on_card(b, s, h, d, w, dtype, tol):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    before = swa_flash.launches
    got = swa_attention(q, k, v, window=w)
    torch.cuda.synchronize()
    assert swa_flash.launches == before + 1
    want = swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), window=w).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=2e-5)


def _ssd_inputs(dev, bs, l, h, p, n, dtype=torch.float32, seed=0):
    """x (bs, l, h, p), dt, a, b, c as ``tests/test_kernels.py`` draws them."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = randn(bs, l, h, p).to(dtype)
    dt = torch.nn.functional.softplus(randn(bs, l, h))
    a = -torch.exp(0.1 * randn(h))
    return x, dt, a, randn(bs, l, n).to(dtype), randn(bs, l, n).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("bc,q,h,p,n,dtype", [
    (16, 128, 24, 64, 128, torch.bfloat16),  # mamba2-130m, batch 4 x 512
    (16, 128, 24, 64, 128, torch.float32),
    (16, 128, 64, 64, 64, torch.bfloat16),   # zamba2-1.2b, batch 4 x 512
    (8, 32, 4, 32, 16, torch.float32),       # tests/test_kernels.py shapes
    (4, 64, 2, 64, 32, torch.float32),
    (6, 32, 8, 16, 64, torch.float32),
    (1, 64, 1, 128, 128, torch.float32),
])
def test_ssd_intra_chunk_matches_plain_on_card(bc, q, h, p, n, dtype):
    dev = _card()
    x, dt, a, b, c = _ssd_inputs(dev, bc, q, h, p, n, dtype)
    before = ssd_intra_chunk.launches
    got = ssd_intra_chunk(x, dt, a, b, c)
    torch.cuda.synchronize()
    assert ssd_intra_chunk.launches == before + 1
    want = ssd_intra_chunk_ref(x, dt, a, b, c)
    # both widen the operands to f32 and sum in f32, in another order:
    # tests/test_kernels.py's bound for the kernel against its oracle
    for got_t, want_t in zip(got, want):
        assert got_t.dtype == torch.float32
        torch.testing.assert_close(got_t, want_t, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssd_chunked_on_card_matches_recurrence_and_continues():
    dev = _card()
    x, dt, a, b, c = _ssd_inputs(dev, 1, 200, 2, 64, 32, seed=1)
    y, final = ssd_chunked(x, dt, a, b, c, 64)  # ragged: 200 = 3 x 64 + 8
    y_seq, s_seq = ssd_sequential_ref(x, dt, a, b, c)
    torch.testing.assert_close(y, y_seq, rtol=1e-3, atol=1e-3)
    torch.testing.assert_close(final, s_seq, rtol=1e-3, atol=1e-3)
    y1, s1 = ssd_chunked(x[:, :96], dt[:, :96], a, b[:, :96], c[:, :96], 64)
    y2, s2 = ssd_chunked(x[:, 96:], dt[:, 96:], a, b[:, 96:], c[:, 96:], 64,
                         initial_state=s1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s2, final, rtol=1e-4, atol=1e-4)
