"""The arithmetic of the port's bf16 ``ssd_intra_chunk`` kernel, emulated on
the CPU, and the rule that gives each of its blocks a group of heads.

The kernel multiplies on bf16 tensor cores, but two of its three products
have an f32 factor: M = CB * decay * dt (y = M x) and w_s B (state =
x^T (w B)).  It splits each f32 factor into bf16 parts and sums the
products of the parts in f32.  Here that is emulated in plain torch at the
mamba2 test shape (BC 2, Q 128, H 4, P 64, N 128, x, b and c in bf16): the
factor is formed in f32 as the kernel forms it, each part is the residual
rounded to bf16 or to tf32 (the low 13 mantissa bits cleared), and the
products of the parts with the exact bf16 operand are summed in f64.  Each
split is held against the plain version under ``SSD_TOL``, the bound
``chip_smoke.py`` holds the kernel to on the card.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
from repro_torch.kernels.ssd_scan.ssd import MAX_GROUP, head_group


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SSD_TOL = dict(rtol=1e-4, atol=1e-4)  # chip_smoke.SSD_TOL
H100_SMS = 132


def _inputs(seed=0, bc=2, q=128, h=4, p=64, n=128):
    """x, dt, a, b, c drawn as tests/test_torch_ssm.py draws them, with x,
    b and c rounded to bf16 (the serving paths' type)."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((bc, q, h, p), dtype=f32)
    dt = np.logaddexp(rng.standard_normal((bc, q, h), dtype=f32),
                      0.0).astype(f32)
    a = -np.exp(0.1 * rng.standard_normal(h, dtype=f32)).astype(f32)
    b = rng.standard_normal((bc, q, n), dtype=f32)
    c = rng.standard_normal((bc, q, n), dtype=f32)
    x, b, c = (torch.from_numpy(t).bfloat16() for t in (x, b, c))
    return x, torch.from_numpy(dt), torch.from_numpy(a), b, c


def _bf16(v):
    return v.bfloat16().float()


def _tf32(v):
    return (v.view(torch.int32) & ~0x1FFF).view(torch.float32)


ROUND = {"bf16": _bf16, "tf32": _tf32}


def _split(v, rnd, parts):
    """``parts`` terms whose sum approximates v: each the residual so far,
    rounded (every residual is exact in f32)."""
    out = []
    for _ in range(parts):
        out.append(rnd(v))
        v = v - out[-1]
    return out


@functools.cache
def _emulated(rounding, parts):
    """(y_intra, states) as the kernel computes them with the given split,
    and the plain version's (y_intra, states)."""
    x, dt, a, b, c = _inputs()
    q = x.shape[1]
    cum = torch.cumsum(dt * a, dim=1)
    # bf16 products are exact; the kernel sums them into one f32 value
    cb = torch.einsum("ktn,ksn->kts", c.double(), b.double()).float()
    seg = cum[:, :, None, :] - cum[:, None, :, :]
    mask = torch.ones(q, q, dtype=torch.bool).tril()[:, :, None]
    decay = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    m = cb[..., None] * decay * dt[:, None, :, :]            # (BC, Q, Q, H)
    w = torch.exp(cum[:, -1:, :] - cum) * dt                 # (BC, Q, H)
    wb = w[..., None] * b.float()[:, :, None, :]             # (BC, Q, H, N)
    xd = x.double()
    rnd = ROUND[rounding]
    y = sum(torch.einsum("ktsh,kshp->kthp", part.double(), xd)
            for part in _split(m, rnd, parts))
    states = sum(torch.einsum("kshn,kshp->khpn", part.double(), xd)
                 for part in _split(wb, rnd, parts))
    y_ref, states_ref, _ = ssd_intra_chunk_ref(x, dt, a, b, c)
    return (y.float(), states.float()), (y_ref, states_ref)


def _share_of_tol(rounding, parts, output):
    """The largest |emulated - plain| as a share of SSD_TOL's bound there
    (above 1: outside SSD_TOL)."""
    got, want = _emulated(rounding, parts)
    i = ("y_intra", "states").index(output)
    bound = SSD_TOL["atol"] + SSD_TOL["rtol"] * want[i].abs()
    return ((got[i] - want[i]).abs() / bound).max().item()


@pytest.mark.parametrize("output", ["y_intra", "states"])
def test_three_part_bf16_split_stays_within_ssd_tol(output):
    """The kernel's split: hi + mid + lo, three m16n8k16 products."""
    got, want = _emulated("bf16", 3)
    i = ("y_intra", "states").index(output)
    torch.testing.assert_close(got[i], want[i], **SSD_TOL)
    assert _share_of_tol("bf16", 3, output) < 0.1


@pytest.mark.parametrize("output", ["y_intra", "states"])
def test_two_part_tf32_split_stays_within_ssd_tol(output):
    """The other split that keeps about f32 precision (two m16n8k8 tf32
    products, at half the bf16 rate: the cost of four bf16 products)."""
    got, want = _emulated("tf32", 2)
    i = ("y_intra", "states").index(output)
    torch.testing.assert_close(got[i], want[i], **SSD_TOL)


@pytest.mark.parametrize("output", ["y_intra", "states"])
def test_one_bf16_pass_falls_outside_ssd_tol(output):
    assert _share_of_tol("bf16", 1, output) > 1


def test_two_part_bf16_split_leaves_no_room_on_y():
    """hi + lo (swa_flash's P.V form) uses more than half of SSD_TOL on y at
    this draw, before the card's own differences from the plain version
    (C B^T summed in another order moved y by up to 7.6e-5 there); three
    parts use less than a tenth of it."""
    assert _share_of_tol("bf16", 2, "y_intra") > 0.5
    assert _share_of_tol("bf16", 3, "y_intra") < 0.1


# ---------------------------------------------------------------- head groups
@pytest.mark.parametrize("bc,h", [
    (16, 24),      # mamba2-130m, batch 4 x 512
    (16, 64),      # zamba2-1.2b, batch 4 x 512
    (64, 5), (64, 7), (16, 5), (8, 7), (1, 7), (3, 1), (200, 64), (4, 0),
    (2 ** 27, 64),
])
def test_head_group_covers_every_head_once(bc, h):
    g = head_group(bc, h, H100_SMS)
    assert 1 <= g <= MAX_GROUP
    groups = -(-h // g)
    # block (chunk, i) owns heads [i G, min((i + 1) G, H)), as the kernel
    owned = [hh for i in range(groups)
             for hh in range(i * g, min(i * g + g, h))]
    assert owned == list(range(h))
    assert bc * groups < 2 ** 31
    if bc * h > H100_SMS:  # enough blocks: the grid stays within a wave
        assert bc * groups <= H100_SMS or g == MAX_GROUP


def test_head_group_at_the_serving_shapes_shares_c_b_over_heads():
    assert head_group(16, 24, H100_SMS) == 3   # 8 groups: 128 blocks
    assert head_group(16, 64, H100_SMS) == 8   # 8 groups: 128 blocks
    assert head_group(64, 5, H100_SMS) == 3    # groups of 3 and 2 heads
