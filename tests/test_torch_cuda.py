"""The hand-written CUDA kernel of the port against its plain PyTorch
version, on a card.  Marked ``cuda``: where there is no card each test
skips (the kernel has no CPU mode).  This file imports no JAX, so it runs
on a machine without it; there, skip the JAX-importing ``conftest.py``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

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
