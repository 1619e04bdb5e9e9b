"""The hand-written CUDA kernels of the port against their plain PyTorch
versions, on a card.  Marked ``cuda``: where there is no card each test
skips (the kernel has no CPU mode).  This file imports no JAX, so it runs
on a machine without it; there, skip the JAX-importing ``conftest.py``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import train_state_from_jax, train_state_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.data import DataPipeline
from repro_torch.kernels.checksum.fingerprint import (BLOCK_WORDS,
                                                       fingerprint_u32)
from repro_torch.kernels.checksum.ops import _as_words, fingerprint
from repro_torch.kernels.checksum.ref import fingerprint_u32_ref
from repro_torch.kernels.fused_ce import fused_cross_entropy
from repro_torch.kernels.fused_ce.ce import fused_ce_stats, tile, vocab_splits
from repro_torch.kernels.fused_ce.ops import fused_ce_shard_stats
from repro_torch.kernels.fused_ce.ref import (cross_entropy_ref,
                                              fused_ce_stats_ref)
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_ref,
                                              ssd_intra_chunk_ref,
                                              ssd_sequential_ref)
from repro_torch.kernels.ssd_scan.ssd import ssd_intra_chunk
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.swa_attention.ref import (swa_attention_bwd_ref,
                                                   swa_attention_lse_ref,
                                                   swa_attention_ref)
from repro_torch.kernels.swa_attention.swa import swa_flash, swa_flash_bwd
from repro_torch.models.frontend import synth_extra_inputs
from repro_torch.training import build_train_step, init_train_state


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,w,dtype,tol", [
    # bf16: the kernel and the plain version each round an f32 result to
    # bf16 once, so they may differ by one bf16 ulp: 2**-7 relative
    (4, 512, 16, 128, 0, torch.bfloat16, 2 ** -7),
    # the training path's shapes: splice 1 (B 4) and splice 2 (B 2) at S
    # 4096, where the kv-tile loop runs 32 times deeper than at S 512
    (4, 4096, 16, 128, 0, torch.bfloat16, 2 ** -7),
    (2, 4096, 16, 128, 0, torch.bfloat16, 2 ** -7),
    # zamba2-1.2b training (32 heads of 64, its window of 4096 = S) and
    # granite-moe-3b-a800m serving and training (24 heads of 64)
    (4, 4096, 32, 64, 4096, torch.bfloat16, 2 ** -7),
    (4, 512, 24, 64, 0, torch.bfloat16, 2 ** -7),
    (4, 4096, 24, 64, 0, torch.bfloat16, 2 ** -7),
    # f32: the same f32 arithmetic summed in another order
    (4, 512, 16, 128, 0, torch.float32, 2e-5),
    (2, 200, 3, 64, 96, torch.float32, 2e-5),
    (1, 128, 1, 32, 48, torch.float32, 2e-5),
    # head dims 80 (paper-gpt2-1.8b) and 120 (h2o-danube-3-4b), whose
    # depth the bf16 kernel pads to 16 with TMA's zero fill
    (2, 300, 4, 80, 0, torch.bfloat16, 2 ** -7),
    (2, 300, 4, 120, 100, torch.bfloat16, 2 ** -7),
    (2, 300, 4, 80, 0, torch.float32, 2e-5),
    (2, 300, 4, 120, 50, torch.float32, 2e-5),
    # bf16 with a window shorter than S, and a ragged S
    (1, 700, 2, 128, 256, torch.bfloat16, 2 ** -7),
    (2, 200, 3, 64, 96, torch.bfloat16, 2 ** -7),
    (1, 100, 2, 8, 0, torch.bfloat16, 2 ** -7),
    # the fleet executor's olmo-1b smoke jobs
    (8, 32, 4, 64, 0, torch.bfloat16, 2 ** -7),
    # h2o-danube-3-4b's prefill past its window (32 heads of 120, window
    # 4096 < S 6144: both ends of each row masked), llama-3.2-vision-11b's
    # prefill (32 heads of 128, the 8 KV heads repeated), whisper-base's
    # prefill (8 heads of 64) and its training slices at splice 1 and 2
    (2, 6144, 32, 120, 4096, torch.bfloat16, 2 ** -7),
    (4, 512, 32, 128, 0, torch.bfloat16, 2 ** -7),
    (4, 512, 8, 64, 0, torch.bfloat16, 2 ** -7),
    (4, 4096, 8, 64, 0, torch.bfloat16, 2 ** -7),
    (2, 4096, 8, 64, 0, torch.bfloat16, 2 ** -7),
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


@pytest.mark.cuda
def test_swa_flash_copies_what_tma_cannot_take():
    """bf16 views that TMA cannot read in place (an address 2 bytes off
    16, a seq stride that is not a multiple of 8) are copied by the
    wrapper, a head slice whose strides are multiples of 8 is read in
    place, and the result is right."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(3)
    b, s, h, d = 2, 256, 4, 120
    # q: heads sliced from a wider tensor; every stride a multiple of 8
    q = torch.randn(b, s, h + 1, d, generator=g, device=dev
                    ).to(torch.bfloat16)[:, :, :h]
    # k: an address 2 bytes past a 16-byte boundary
    k = torch.empty(b * s * h * d + 1, device=dev,
                    dtype=torch.bfloat16)[1:].view(b, s, h, d)
    k.copy_(torch.randn(b, s, h, d, generator=g, device=dev))
    # v: a seq stride of h * d + 4 = 484 elements
    v = torch.empty(b, s, h * d + 4, device=dev,
                    dtype=torch.bfloat16)[:, :, :h * d].view(b, s, h, d)
    v.copy_(torch.randn(b, s, h, d, generator=g, device=dev))
    before = swa_flash.copies
    got = swa_attention(q, k, v, window=0)
    torch.cuda.synchronize()
    assert swa_flash.copies == before + 2
    want = swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2)).transpose(1, 2)
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2e-5)


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
    # mamba2-130m training, 4 x 4096 tokens (splice 1) and 2 x 4096
    # (splice 2): groups of 8 heads, 3 groups, several waves
    (128, 128, 24, 64, 128, torch.bfloat16),
    (64, 128, 24, 64, 128, torch.bfloat16),
    # zamba2-1.2b training, splice 1: 64 heads in groups of 8, N 64
    (128, 128, 64, 64, 64, torch.bfloat16),
    # the fleet executor's mamba2-130m smoke jobs: 8 and 4 sequences of
    # one 32-step chunk
    (8, 32, 16, 32, 16, torch.bfloat16),
    (4, 32, 16, 32, 16, torch.bfloat16),
    # bf16 in groups of 3 heads (64 chunks): the other head dims, a ragged
    # chunk, N not a multiple of 16, an odd N (rows not 16-byte aligned,
    # read element by element) and H 5 (a last group of 2)
    (64, 128, 6, 16, 64, torch.bfloat16),
    (64, 128, 6, 32, 64, torch.bfloat16),
    (64, 128, 6, 128, 128, torch.bfloat16),
    (64, 100, 6, 64, 64, torch.bfloat16),
    (64, 128, 6, 64, 40, torch.bfloat16),
    (64, 128, 6, 64, 33, torch.bfloat16),
    (64, 128, 5, 64, 64, torch.bfloat16),
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
def test_ssd_intra_chunk_reads_unaligned_rows_on_card():
    """bf16 x 2 bytes past a 16-byte boundary and b with a row stride of
    N + 8: read element by element and by cp.async, no copy."""
    dev = _card()
    bc, q, h, p, n = 8, 128, 6, 64, 64
    x, dt, a, b, c = _ssd_inputs(dev, bc, q, h, p, n, torch.bfloat16, seed=2)
    x_off = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    x_off = x_off.view(x.shape).copy_(x)
    b_wide = torch.zeros(bc, q, n + 8, dtype=b.dtype, device=dev)[..., :n]
    b_wide.copy_(b)
    got = ssd_intra_chunk(x_off, dt, a, b_wide, c)
    torch.cuda.synchronize()
    for got_t, want_t in zip(got, ssd_intra_chunk_ref(x, dt, a, b, c)):
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-5),    # the same f32 arithmetic in another order
    # the kernel's bf16 products split M and w B in three bf16 parts, the
    # plain version's are f32: outputs within 1e-4 (SSD_TOL), gradients
    # (the same plain backward on both) within 1e-3 of their largest entry
    (torch.bfloat16, 1e-3),
])
def test_ssd_chunked_gradients_on_card(dtype, tol):
    """Gradients in x, dt, a, b, c and the initial state through the
    autograd function (the kernel forward, the plain recomputing backward)
    against autograd through the plain chunked scan, at a ragged length.
    The gradients of bf16 inputs are rounded to bf16 once on each side, so
    where their f32 values differ in the last bits they may differ by one
    bf16 ulp: 2**-7 relative on top of ``tol``."""
    dev = _card()
    ins = list(_ssd_inputs(dev, 2, 300, 24, 64, 128, dtype, seed=3))
    ins.append(torch.randn(2, 24, 64, 128, device=dev))
    g = torch.Generator(device=dev).manual_seed(4)
    wy = torch.randn(2, 300, 24, 64, generator=g, device=dev)
    ws = torch.randn(2, 24, 64, 128, generator=g, device=dev)
    grads = []
    for fn in (ssd_chunked, ssd_chunked_ref):
        leaves = [t.detach().requires_grad_() for t in ins]
        before = ssd_intra_chunk.launches
        y, final = fn(*leaves[:5], 128, initial_state=leaves[5])
        ((y.float() * wy).sum() + (final * ws).sum()).backward()
        assert ssd_intra_chunk.launches == before + (fn is ssd_chunked)
        grads.append([t.grad for t in leaves])
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        scale = want.float().abs().max()
        ulp = 2 ** -7 if got.dtype == torch.bfloat16 else 0
        torch.testing.assert_close(got.float() / scale, want.float() / scale,
                                   rtol=ulp, atol=tol)


def _ce_inputs(dev, t, d, v, dtype, seed=0, tied=True):
    """hidden ~ N(0, 1) and head ~ 0.02 N(0, 1) (dense_init's scale), the
    head as ``embed.T`` (strides (1, d)) when ``tied``; labels in [-1, V)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    h = torch.randn(t, d, generator=g, device=dev).to(dtype)
    if tied:
        w = (0.02 * torch.randn(v, d, generator=g, device=dev)).to(dtype).T
    else:
        w = (0.02 * torch.randn(d, v, generator=g, device=dev)).to(dtype)
    lab = torch.randint(-1, v, (t,), generator=g, device=dev)
    return h, w, lab


@pytest.mark.cuda
@pytest.mark.parametrize("t,d,v,dtype,tied", [
    (16384, 2048, 50304, torch.bfloat16, True),   # olmo-1b, splice 1
    (8192, 2048, 50304, torch.bfloat16, True),    # splice 2
    (300, 256, 777, torch.float32, True),         # ragged T and V
    (130, 64, 500, torch.float32, False),         # a contiguous (d, V) head
    (256, 128, 1024, torch.bfloat16, False),
    (100, 32, 512, torch.float32, True),
    # bf16 at the 128 x 256 tile: ragged T and V (5000 = 19.5 tiles) with
    # an untied (d, V) head read in place (MN-major), a tied one, and an
    # untied one whose row stride (777) TMA cannot take (copied)
    (1000, 2048, 5000, torch.bfloat16, False),
    (300, 256, 777, torch.bfloat16, True),
    (300, 256, 777, torch.bfloat16, False),
    # the fleet executor's smoke jobs (olmo-1b and mamba2-130m)
    (256, 256, 512, torch.bfloat16, True),
    (128, 256, 512, torch.bfloat16, True),
    # zamba2-1.2b's untied (2048, 32000) head, read in place, and
    # granite-moe-3b-a800m's (1536, 49155), copied for TMA
    (16384, 2048, 32000, torch.bfloat16, False),
    (16384, 1536, 49155, torch.bfloat16, False),
    # whisper-base's untied (512, 51865) head, copied for TMA, at splice 1
    # and 2
    (16384, 512, 51865, torch.bfloat16, False),
    (8192, 512, 51865, torch.bfloat16, False),
])
def test_fused_ce_stats_matches_plain_on_card(t, d, v, dtype, tied):
    """lse and pick within 1e-4 of the plain version: both sum the same
    f32 products (exact at bf16) in another order, over d <= 2048 terms of
    logits about 1; labels outside [0, V) give pick = -1e30 in both.  A
    bf16 head is copied for TMA only when it is untied and V is no
    multiple of 8."""
    dev = _card()
    h, w, lab = _ce_inputs(dev, t, d, v, dtype, tied=tied)
    before, copies = fused_ce_stats.launches, fused_ce_stats.copies
    lse, pick = fused_ce_stats(h, w, lab)
    torch.cuda.synchronize()
    assert fused_ce_stats.launches == before + 1
    assert fused_ce_stats.copies - copies == int(
        dtype == torch.bfloat16 and not tied and v % 8 != 0)
    want_lse, want_pick = fused_ce_stats_ref(h, w, lab)
    assert lse.shape == pick.shape == (t, 1)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(pick, want_pick, rtol=1e-5, atol=1e-4)
    assert (pick[lab < 0] == -1e30).all()


@pytest.mark.cuda
def test_fused_ce_stats_tiles_come_from_the_library():
    """The library reports its tiles, and the split of olmo-1b's vocab at
    splice 1 and 2 is the one tests/test_torch_fused_ce.py checks."""
    _card()
    assert tile(torch.bfloat16) == (128, 256)
    assert tile(torch.float32) == (64, 64)
    assert [vocab_splits(t, 50304, tile(torch.bfloat16), 132)
            for t in (16384, 8192)] == [3, 5]


@pytest.mark.cuda
def test_fused_ce_stats_refuses_what_it_cannot_take():
    dev = _card()
    h, w, lab = _ce_inputs(dev, 64, 48, 100, torch.float32)
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_ce_stats(h, w, lab)
    h, w, lab = _ce_inputs(dev, 64, 64, 100, torch.float32)
    with pytest.raises(ValueError, match="both float32 or both bfloat16"):
        fused_ce_stats(h.to(torch.bfloat16), w, lab)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ce_stats(h.T.contiguous().T, w, lab)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [
    (torch.float32, 1e-5),    # the same f32 arithmetic in another order
    (torch.bfloat16, 1e-2),   # dh rounds to bf16 in the port, not the plain
])
def test_fused_cross_entropy_gradients_on_card(dtype, tol):
    """Loss and gradients in hidden and head through the autograd function
    (the kernel forward, the chunked plain backward) against autograd
    through the full-logits plain version, on the card."""
    dev = _card()
    h, w, lab = _ce_inputs(dev, 2 * 2048 + 72, 256, 1000, dtype, seed=1)
    emb = w.T.detach().float().requires_grad_()
    hh = h.detach().requires_grad_()
    before = fused_ce_stats.launches
    loss, count = fused_cross_entropy(hh, emb.T.to(dtype), lab)
    loss.backward()
    assert fused_ce_stats.launches == before + 1
    emb2 = w.T.detach().float().requires_grad_()
    hh2 = h.detach().requires_grad_()
    want, want_count = cross_entropy_ref(hh2, emb2.T.to(dtype), lab)
    want.backward()
    assert count.item() == want_count.item()
    torch.testing.assert_close(loss, want, rtol=1e-5, atol=0)
    for got, ref in ((hh.grad, hh2.grad), (emb.grad, emb2.grad)):
        scale = ref.float().abs().max()
        torch.testing.assert_close(got.float() / scale, ref.float() / scale,
                                   rtol=0, atol=tol)


@pytest.mark.cuda
def test_fused_ce_shard_stats_on_card():
    """One vocabulary slice's (lse, label logit) and their gradients: the
    kernel forward (one launch) against the same function on CPU copies
    (its plain version), f32, 1e-5 of the largest gradient entry."""
    dev = _card()
    h, w, lab = _ce_inputs(dev, 1000, 256, 2048, torch.float32, seed=2)
    head = w[:, 1024:]
    lab = lab - 1024
    got, want = [], []
    for out, dv in ((got, dev), (want, torch.device("cpu"))):
        hh = h.detach().to(dv).requires_grad_()
        ww = head.detach().to(dv).requires_grad_()
        before = fused_ce_stats.launches
        lse, pick = fused_ce_shard_stats(hh, ww, lab.to(dv))
        assert fused_ce_stats.launches == before + (dv.type == "cuda")
        (lse.square().sum() - 3 * pick.sum()).backward()
        out += [t.detach().cpu() for t in (lse, pick, hh.grad, ww.grad)]
    for a, b in zip(got, want):
        scale = b.abs().max()
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,w,dtype,tol", [
    (2, 512, 4, 128, 0, torch.float32, 1e-5),
    (1, 300, 2, 64, 96, torch.float32, 1e-5),
    # bf16 through the backward kernel (``swa_flash_bwd``).  2e-2 of the
    # largest entry: each of dq, dk, dv is one bf16 rounding (2^-9
    # relative) from an f32 result on both sides; the kernel's f32 sums
    # differ besides by the hi + lo residual of P and dS (about 2^-17 of
    # each), by delta taken from the bf16 o, and by the f32 atomics of dq,
    # added in an order that changes from run to run.
    (2, 512, 4, 128, 0, torch.bfloat16, 2e-2),
    (2, 512, 4, 64, 0, torch.bfloat16, 2e-2),
    # padded head dims (80: D16 80, 120: D16 128), ragged S, a window
    (2, 300, 3, 80, 0, torch.bfloat16, 2e-2),
    (2, 300, 3, 120, 100, torch.bfloat16, 2e-2),
    (2, 300, 4, 64, 96, torch.bfloat16, 2e-2),
    (3, 130, 2, 32, 0, torch.bfloat16, 2e-2),
    (2, 1000, 2, 128, 256, torch.bfloat16, 2e-2),
    # the training calls at S 4096: olmo-1b (16 heads of 128) and
    # granite-moe-3b-a800m (24 heads of 64), one batch row
    (1, 4096, 16, 128, 0, torch.bfloat16, 2e-2),
    (1, 4096, 24, 64, 0, torch.bfloat16, 2e-2),
])
def test_swa_attention_gradients_on_card(b, s, h, d, w, dtype, tol):
    """dq, dk, dv through the autograd function (the kernel forward; the
    backward kernel in bf16, the plain recomputing backward in f32)
    against autograd through the plain version; each to ``tol`` of the
    largest entry.  A bf16 call launches ``swa_flash_bwd`` exactly once."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
                   for _ in range(4))
    ins = [x.detach().requires_grad_() for x in (q, k, v)]
    before = swa_flash.launches, swa_flash_bwd.launches
    swa_attention(*ins, window=w).backward(do)
    torch.cuda.synchronize()
    assert swa_flash.launches == before[0] + 1
    assert swa_flash_bwd.launches == before[1] + (dtype == torch.bfloat16)
    refs = [x.detach().requires_grad_() for x in (q, k, v)]
    swa_attention_ref(*(x.transpose(1, 2) for x in refs),
                      window=w).transpose(1, 2).backward(do)
    for got, ref in zip(ins, refs):
        assert got.grad.dtype == dtype
        assert torch.isfinite(got.grad).all()
        scale = ref.grad.float().abs().max()
        torch.testing.assert_close(got.grad.float() / scale,
                                   ref.grad.float() / scale, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,d,w,dtype", [
    (2, 512, 4, 128, 0, torch.bfloat16),
    (2, 300, 3, 80, 100, torch.bfloat16),
    (1, 4096, 16, 128, 0, torch.bfloat16),
    (2, 300, 3, 64, 96, torch.float32),
])
def test_swa_flash_lse_matches_plain_on_card(b, s, h, d, w, dtype):
    """The forward's log-sum-exp against the plain one over the same
    scores, to 1e-5 relative (and 1e-5 absolute, for a row whose lse is
    near 0): both sum f32 products of the same inputs, in other orders."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    o, lse = swa_flash(q, k, v, window=w)
    torch.cuda.synchronize()
    _, want = swa_attention_lse_ref(
        *(x.transpose(1, 2) for x in (q, k, v)), window=w)
    assert o.shape == q.shape
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_swa_flash_bwd_rejects_what_it_does_not_take():
    """f32 and a lse of another shape raise; nothing launches."""
    dev = _card()
    q = torch.zeros(1, 64, 2, 64, device=dev)
    lse = torch.zeros(1, 2, 64, device=dev)
    before = swa_flash_bwd.launches
    with pytest.raises(ValueError, match="bfloat16"):
        swa_flash_bwd(q, q, q, q, q, lse, window=0)
    qb = q.to(torch.bfloat16)
    with pytest.raises(ValueError, match="lse"):
        swa_flash_bwd(qb, qb, qb, qb, qb, lse[:, :1], window=0)
    assert swa_flash_bwd.launches == before


@pytest.mark.cuda
def test_bf16_smoke_train_step_runs_the_backward_kernel():
    """One spliced step (splice 2) of the olmo smoke config in its bf16 on
    the card launches ``swa_flash_bwd`` once per layer and slice (and
    ``swa_flash`` twice, under remat), and its loss and gradient norm
    equal those of the same step with the plain backward in the kernel's
    place (the ops' CUDA implementation calls the wrapper by the module's
    name).  The loss equals bit for bit (the forward is the same); the
    gradient norm to 2e-3: each layer's dq, dk, dv are one bf16 rounding
    from the plain ones, at random signs over many entries."""
    dev = _card()
    cfg = get_smoke_config("olmo-1b")
    assert cfg.dtype == "bfloat16"
    tcfg = TrainConfig(total_steps=40, warmup_steps=2, learning_rate=1e-3)
    state = init_train_state(cfg, tcfg, device="cpu")
    tokens, labels = DataPipeline(cfg.vocab_size, 128, 4, 4).next_batch()
    batch = {"tokens": torch.as_tensor(tokens, device=dev).long(),
             "labels": torch.as_tensor(labels, device=dev).long()}
    step = build_train_step(cfg, tcfg, splice=2)
    out = []
    for plain in (False, True):
        card_state = train_state_from_jax(train_state_to_numpy(state), cfg,
                                          device=dev)
        saved = swa_ops.swa_flash_bwd
        if plain:
            swa_ops.swa_flash_bwd = (
                lambda q, k, v, o, dout, lse, *, window:
                swa_attention_bwd_ref(q, k, v, dout, window))
        before = swa_flash.launches, swa_flash_bwd.launches
        try:
            _, metrics = step(card_state, batch)
            torch.cuda.synchronize()
        finally:
            swa_ops.swa_flash_bwd = saved
        launched = (swa_flash.launches - before[0],
                    swa_flash_bwd.launches - before[1])
        assert launched == (2 * 2 * cfg.num_layers,
                            0 if plain else 2 * cfg.num_layers)
        out.append((metrics["loss"].item(), metrics["grad_norm"].item()))
    (loss, norm), (loss_p, norm_p) = out
    assert np.isfinite([loss, norm]).all()
    assert loss == loss_p
    np.testing.assert_allclose(norm, norm_p, rtol=2e-3)


@pytest.mark.cuda
def test_smoke_train_step_card_matches_cpu():
    """One spliced step (splice 2) of the olmo smoke config at f32 from one
    state on the card and on the CPU: loss at 1e-5; m and v at 1e-5 of each
    leaf's largest entry; params at 1e-3 lr where the gradient is at least
    1e-6 and 2 lr elsewhere (AdamW's first step moves an entry whose
    gradient is near eps by an amount resting on the gradient's last
    bits; see ``tests/test_torch_train.py``)."""
    dev = _card()
    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    tcfg = TrainConfig(total_steps=40, warmup_steps=2, learning_rate=1e-3)
    cpu_state = init_train_state(cfg, tcfg, device="cpu")
    card_state = train_state_from_jax(train_state_to_numpy(cpu_state), cfg,
                                      device=dev)
    tokens, labels = DataPipeline(cfg.vocab_size, 64, 4, 4).next_batch()
    step = build_train_step(cfg, tcfg, splice=2)
    out = {}
    for name, state, device in (("cpu", cpu_state, "cpu"),
                                ("card", card_state, dev)):
        batch = {"tokens": torch.as_tensor(tokens, device=device).long(),
                 "labels": torch.as_tensor(labels, device=device).long()}
        new, metrics = step(state, batch)
        out[name] = (train_state_to_numpy(new), metrics["loss"].item(),
                     metrics["lr"].item())
    (cpu_new, cpu_loss, lr), (card_new, card_loss, _) = out["cpu"], out["card"]
    np.testing.assert_allclose(card_loss, cpu_loss, rtol=1e-5)

    def leaves(t):
        if isinstance(t, dict):
            return [x for val in t.values() for x in leaves(val)]
        return [] if t is None else [t]

    for part in ("m", "v"):
        for a, b in zip(leaves(card_new["opt"][part]),
                        leaves(cpu_new["opt"][part])):
            scale = np.abs(b).max()
            np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                       atol=1e-5)
    for a, b, m in zip(leaves(card_new["params"]), leaves(cpu_new["params"]),
                       leaves(cpu_new["opt"]["m"])):
        # as tests/test_torch_train.py's assert_first_adamw_step_close
        firm = np.abs(m) / (1 - tcfg.beta1) >= 1e-6
        assert 1 - firm.mean() < 0.05
        np.testing.assert_allclose(a[firm], b[firm], rtol=0, atol=1e-3 * lr)
        np.testing.assert_allclose(a[~firm], b[~firm], rtol=0, atol=0.2 * lr)


@pytest.mark.cuda
def test_mamba2_smoke_train_step_card_matches_cpu():
    """One spliced step (splice 2) of the mamba2 smoke config at f32 from
    one state on the card (``ssd_intra_chunk`` and ``fused_ce_stats``) and
    on the CPU (their plain versions): loss and grad_norm at 1e-5; m and v
    at 1e-5 of each leaf's largest entry; params at 1e-3 lr where the two
    sides' gradients agree to 1e-3 relative (a relative change r of g moves
    AdamW's first step by at most lr r / 4) and 0.2 lr on the rest, under
    5% of each leaf (``tests/test_torch_ssm_train.py``)."""
    dev = _card()
    cfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                              dtype="float32")
    tcfg = TrainConfig(total_steps=40, warmup_steps=2, learning_rate=1e-3)
    cpu_state = init_train_state(cfg, tcfg, device="cpu")
    card_state = train_state_from_jax(train_state_to_numpy(cpu_state), cfg,
                                      device=dev)
    tokens, labels = DataPipeline(cfg.vocab_size, 96, 4, 4).next_batch()
    step = build_train_step(cfg, tcfg, splice=2)
    out = {}
    for name, state, device in (("cpu", cpu_state, "cpu"),
                                ("card", card_state, dev)):
        batch = {"tokens": torch.as_tensor(tokens, device=device).long(),
                 "labels": torch.as_tensor(labels, device=device).long()}
        before = ssd_intra_chunk.launches
        new, metrics = step(state, batch)
        # 2 layers x 2 slices, again in remat's recomputation
        assert ssd_intra_chunk.launches - before == (8 if name == "card"
                                                     else 0)
        out[name] = (train_state_to_numpy(new), metrics)
    (cpu_new, cpu_m), (card_new, card_m) = out["cpu"], out["card"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(card_m[key].item(), cpu_m[key].item(),
                                   rtol=1e-5)
    lr = cpu_m["lr"].item()

    def leaves(t):
        if isinstance(t, dict):
            return [x for val in t.values() for x in leaves(val)]
        return [] if t is None else [t]

    for part in ("m", "v"):
        for a, b in zip(leaves(card_new["opt"][part]),
                        leaves(cpu_new["opt"][part])):
            scale = np.abs(b).max()
            np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                       atol=1e-5)
    for a, b, ma, mb in zip(leaves(card_new["params"]),
                            leaves(cpu_new["params"]),
                            leaves(card_new["opt"]["m"]),
                            leaves(cpu_new["opt"]["m"])):
        firm = np.abs(ma - mb) <= 1e-3 * np.abs(mb)
        assert 1 - firm.mean() < 0.05
        np.testing.assert_allclose(a[firm], b[firm], rtol=0, atol=1e-3 * lr)
        np.testing.assert_allclose(a[~firm], b[~firm], rtol=0, atol=0.2 * lr)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,layers,per_slice", [
    # 5 layers: two groups of 2 Mamba2 layers with the shared block, and
    # a tail layer; under remat each layer's kernel runs twice
    ("zamba2-1.2b", 5, {"ssd_intra_chunk": 10, "swa_flash": 4}),
    ("granite-moe-3b-a800m", 2, {"ssd_intra_chunk": 0, "swa_flash": 4}),
    # whisper-base: 2 decoder layers (the encoder and the cross blocks run
    # the plain core); llama-3.2-vision-11b: two groups of 2 layers
    ("whisper-base", 2, {"ssd_intra_chunk": 0, "swa_flash": 4}),
    ("llama-3.2-vision-11b", 4, {"ssd_intra_chunk": 0, "swa_flash": 8}),
])
def test_new_family_smoke_train_step_card_matches_cpu(arch, layers,
                                                      per_slice):
    """One spliced step (splice 2) of the hybrid, MoE, audio and VLM smoke
    configs at f32 from one state on the card and on the CPU, held as the
    mamba2 one above: loss and grad_norm at 1e-5, m and v at 1e-5 of each
    leaf's largest entry, params at 1e-3 lr where the two sides' gradients
    agree to 1e-3 relative and 0.2 lr on the rest (under 5% of each leaf).
    The kernels launch per slice as counted in ``per_slice``.  The audio
    and VLM cross gates are set nonzero, and both sides get the same frame
    or patch embeddings."""
    dev = _card()
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                              num_layers=layers)
    tcfg = TrainConfig(total_steps=40, warmup_steps=2, learning_rate=1e-3)
    cpu_state = init_train_state(cfg, tcfg, device="cpu")
    _set_gates(cpu_state["params"])
    card_state = train_state_from_jax(train_state_to_numpy(cpu_state), cfg,
                                      device=dev)
    tokens, labels = DataPipeline(cfg.vocab_size, 96, 4, 4).next_batch()
    extra = synth_extra_inputs(cfg, 4, 1)
    step = build_train_step(cfg, tcfg, splice=2)
    counters = {"ssd_intra_chunk": ssd_intra_chunk, "swa_flash": swa_flash}
    out = {}
    for name, state, device in (("cpu", cpu_state, "cpu"),
                                ("card", card_state, dev)):
        batch = {"tokens": torch.as_tensor(tokens, device=device).long(),
                 "labels": torch.as_tensor(labels, device=device).long(),
                 **{k: v.to(device) for k, v in extra.items()}}
        before = {key: fn.launches for key, fn in counters.items()}
        new, metrics = step(state, batch)
        launched = {key: fn.launches - before[key]
                    for key, fn in counters.items()}
        assert launched == {key: 2 * n if name == "card" else 0
                            for key, n in per_slice.items()}
        out[name] = (train_state_to_numpy(new), metrics)
    (cpu_new, cpu_m), (card_new, card_m) = out["cpu"], out["card"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(card_m[key].item(), cpu_m[key].item(),
                                   rtol=1e-5)
    lr = cpu_m["lr"].item()

    def leaves(t):
        if isinstance(t, dict):
            return [x for val in t.values() for x in leaves(val)]
        return [] if t is None else [t]

    for part in ("m", "v"):
        for a, b in zip(leaves(card_new["opt"][part]),
                        leaves(cpu_new["opt"][part])):
            scale = np.abs(b).max()
            np.testing.assert_allclose(a / scale, b / scale, rtol=0,
                                       atol=1e-5)
    for a, b, ma, mb in zip(leaves(card_new["params"]),
                            leaves(cpu_new["params"]),
                            leaves(card_new["opt"]["m"]),
                            leaves(cpu_new["opt"]["m"])):
        firm = np.abs(ma - mb) <= 1e-3 * np.abs(mb)
        assert 1 - firm.mean() < 0.05
        np.testing.assert_allclose(a[firm], b[firm], rtol=0, atol=1e-3 * lr)
        np.testing.assert_allclose(a[~firm], b[~firm], rtol=0, atol=0.2 * lr)


def _set_gates(params, seed=0):
    """The cross gates (audio, VLM) set to uniform [0.3, 0.9): at zero, a
    cross block adds nothing."""
    if "cross" in params:
        gate = params["cross"]["gate"]
        gate.copy_(torch.from_numpy(np.random.default_rng(seed).uniform(
            0.3, 0.9, gate.shape)))


@pytest.mark.cuda
@pytest.mark.parametrize("arch,prompt,swa_per_prefill", [
    ("h2o-danube-3-4b", 160, 2),     # past its smoke window of 128
    ("whisper-base", 48, 2),
    ("llama-3.2-vision-11b", 48, 2),
])
def test_new_family_smoke_prefill_card_matches_cpu(arch, prompt,
                                                   swa_per_prefill):
    """The smoke config at f32, gates set, the same weights and frame or
    patch embeddings on both devices: the card's prefill logits, KV and
    cross caches within 1e-4 of the CPU's (the kernel against the plain
    version), ``swa_flash`` launched once per layer, and 8 greedy tokens
    equal, decoded past the window for h2o-danube."""
    dev = _card()
    from repro_torch.bridge import params_from_jax, params_to_numpy
    from repro_torch.models import decode_step_fn, init_params, prefill_fn

    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu_params = init_params(cfg, 0, device="cpu")
    _set_gates(cpu_params)
    card_params = params_from_jax(params_to_numpy(cpu_params), cfg, dev)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, prompt)))
    extra = synth_extra_inputs(cfg, 2, 1)
    out = {}
    for device, params in (("cpu", cpu_params), (dev, card_params)):
        batch = {"tokens": tokens.to(device),
                 **{k: v.to(device) for k, v in extra.items()}}
        before = swa_flash.launches
        with torch.inference_mode():
            logits, state = prefill_fn(params, batch, cfg,
                                       cache_len=prompt + 8)
            launched = swa_flash.launches - before
            toks = [logits.argmax(-1)]
            for _ in range(7):
                step_logits, state = decode_step_fn(params, state, toks[-1],
                                                    cfg)
                toks.append(step_logits.argmax(-1))
        out[str(device)] = (logits.cpu(), state, torch.stack(toks, 1).cpu(),
                            launched)
    (cpu_l, cpu_s, cpu_t, cpu_n), (card_l, card_s, card_t, card_n) = \
        out["cpu"], out[str(dev)]
    assert (cpu_n, card_n) == (0, swa_per_prefill)
    torch.testing.assert_close(card_l, cpu_l, rtol=1e-4, atol=1e-4)
    for key in ("kv", "cross_kv"):
        for name in ("k", "v"):
            if key in cpu_s:
                torch.testing.assert_close(card_s[key][name].cpu(),
                                           cpu_s[key][name], rtol=1e-4,
                                           atol=1e-4)
    assert torch.equal(card_t, cpu_t)


@pytest.mark.cuda
def test_executor_scenario_on_card_logs_as_on_cpu():
    """tests/test_executor.py's preemption scenario on the card: the basic
    olmo job is preempted by a premium mamba2 job and restored at the
    exact step; every runtime lives on the card; the log equals the CPU's,
    event for event."""
    dev = _card()
    from repro_torch.scheduler.executor import FleetExecutor, ManagedJob
    from repro_torch.scheduler.job_table import TableJob
    from repro_torch.scheduler.scenarios import (
        tiered_fleet_with_real_preemption_and_resume as scenario)

    logs = {str(device): scenario(FleetExecutor, ManagedJob, TableJob, device)
            for device in ("cpu", dev)}
    assert logs["cpu"] == logs[str(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype", [
    # tests/test_kernels.py's shapes
    ((1000,), torch.float32), ((64, 128), torch.bfloat16),
    ((7, 11, 13), torch.int32), ((100_000,), torch.float32),
    ((3, 5), torch.float32), ((256, 128), torch.uint8),
    # 16-bit floats (zero-extended), 1-byte and 8-byte types, a length
    # that is not a multiple of the block, and two blocks exactly
    ((33, 7), torch.float16), ((4096, 7), torch.bfloat16),
    ((77,), torch.int8), ((50,), torch.bool), ((3000,), torch.int64),
    ((40_000,), torch.float32), ((2 * BLOCK_WORDS,), torch.int32),
])
def test_fingerprint_u32_matches_plain_on_card(shape, dtype):
    """Bit for bit: the sums are mod 2^32, so any order gives the same
    digest."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(0)
    if dtype.is_floating_point:
        x = torch.randn(shape, generator=g, device=dev).to(dtype)
    else:
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                          device=dev).to(dtype)
    before = fingerprint_u32.launches
    got = fingerprint(x)
    torch.cuda.synchronize()
    assert fingerprint_u32.launches == before + 1
    assert got.dtype == torch.uint32 and got.device == x.device
    want = fingerprint_u32_ref(_as_words(x))
    assert got.cpu().tolist() == want.cpu().tolist()
    assert got.cpu().tolist() == fingerprint(x.cpu()).tolist()


@pytest.mark.cuda
def test_fingerprint_u32_unaligned_views_and_edges_on_card():
    """A view that starts 4, 8 or 12 bytes into its buffer takes the
    kernel's scalar loads; the words are read in place, not padded; a 0-d
    tensor is one word; an empty one launches nothing."""
    dev = _card()
    x = torch.randn(50_001, generator=torch.Generator(device=dev)
                    .manual_seed(1), device=dev)
    for off in (1, 2, 3):
        view = x[off:]
        assert view.data_ptr() % 16 != 0
        assert fingerprint(view).cpu().tolist() == \
            fingerprint(view.cpu()).tolist()
    step = torch.tensor(7, dtype=torch.int32, device=dev)
    assert fingerprint(step).cpu().tolist() == \
        fingerprint(step.cpu()).tolist()
    before = fingerprint_u32.launches
    assert fingerprint(torch.zeros(0, device=dev)).cpu().tolist() == [0] * 4
    assert fingerprint_u32.launches == before
    with pytest.raises(ValueError, match="4-byte"):
        fingerprint_u32(torch.zeros(8, dtype=torch.int16, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        fingerprint_u32(torch.zeros(8, 8, device=dev).T)


def _donate_runs(arch, steps, physical=(4, 2)):
    """Losses and final states of ``steps`` steps of the arch's smoke config
    on the card, functional and donated, from copies of one state (a
    resize from ``physical[0]`` to ``physical[1]`` after the first
    three)."""
    from repro_torch.core.elastic import ElasticRuntime
    from repro_torch.utils.tree import tree_map

    card = _card()
    cfg = get_smoke_config(arch)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=2, learning_rate=1e-3)
    state = init_train_state(cfg, tcfg, device=card)
    out = {}
    for donate in (False, True):
        rt = ElasticRuntime(cfg, tcfg, 4, physical[0], 8, 128,
                            state=tree_map(torch.clone, state), device=card,
                            donate=donate)
        hist = rt.run_steps(min(steps, 3))
        if steps > 3:
            rt.resize(physical[1])
            hist += rt.run_steps(steps - 3)
        out[donate] = ([h["loss"] for h in hist],
                       train_state_to_numpy(rt.state))
    return out


@pytest.mark.cuda
def test_donated_step_equals_functional_on_card():
    """The ``donate`` phase of chip_smoke.py: olmo-1b smoke, three steps in
    place against three functional ones: losses, params, m and v equal to
    the bit (the same elementwise arithmetic; the gradients laid out alike
    on both paths, so the norm sums in the same order)."""
    from repro_torch.utils.tree import tree_leaves

    out = _donate_runs("olmo-1b", 3)
    assert out[True][0] == out[False][0]
    for a, b in zip(tree_leaves(out[True][1]), tree_leaves(out[False][1])):
        assert np.array_equal(a, b)


@pytest.mark.cuda
def test_donated_granite_step_on_card():
    """granite-moe smoke, five steps with a resize, donated against
    functional: its ``index_add_`` sums with atomics, so the two may differ
    in the last bits; losses to 1e-4 relative (phase 9's bound of the
    kernel path against the plain one)."""
    out = _donate_runs("granite-moe-3b-a800m", 5)
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-4)


@pytest.mark.cuda
def test_donated_update_transient_memory_on_card():
    """One donated update: the peak above what was allocated before it is
    under two axis-0 slices of the largest leaf (a (32, 40, 1536, 512)
    expert stack's layer, 126 MB), where the functional update makes a new
    params, m and v (three such leaves, 12 GB)."""
    from repro_torch.optim.adamw import adamw_init, adamw_update_
    from repro_torch.utils.tree import tree_map

    card = _card()
    gen = torch.Generator(device=card).manual_seed(0)
    params = {"wi": torch.randn(32, 40, 1536, 512, device=card,
                                generator=gen),
              "embed": torch.randn(49155, 1536, device=card, generator=gen)}
    grads = tree_map(lambda p: 1e-3 * torch.randn(p.shape, device=card,
                                                  generator=gen), params)
    opt = adamw_init(params)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    adamw_update_(params, grads, opt, 1e-3, TrainConfig())
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - before
    assert transient < 2 * params["wi"][0].numel() * 4, transient


@pytest.mark.cuda
def test_spans_stay_off_the_device_trace_on_card():
    """One step of the granite smoke job on the card (splice 2, full
    remat) under the profiler's CPU and CUDA activity: no device event
    carries a span's name (a span is a host operator, not an annotation
    the profiler mirrors on the device), every span is recorded, and the
    spans hold the device time of their kernels, on autograd's thread
    too (``step.grad_sum``, the recomputed ``moe.dispatch``)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.elastic import ElasticRuntime
    from repro_torch.utils.spans import NAMES

    dev = _card()
    cfg = get_smoke_config("granite-moe-3b-a800m")
    rt = ElasticRuntime(cfg, TrainConfig(total_steps=40, warmup_steps=2),
                        4, 2, 8, 64, device=dev)
    rt.run_steps(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        rt.run_steps(1)
    cuda = torch.autograd.DeviceType.CUDA
    on_device = {e.name for e in prof.events() if e.device_type == cuda}
    assert on_device and not on_device & set(NAMES)
    ops = {e.key: e for e in prof.key_averages() if e.device_type != cuda}
    assert set(NAMES) <= set(ops)
    for name in ("step.update", "step.grad_sum", "moe.dispatch",
                 "moe.combine"):
        assert ops[name].device_time_total > 0, name
