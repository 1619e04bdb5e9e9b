"""The port's fused cross-entropy and attention gradients against the JAX
package, on the CPU.

- ``fused_ce_stats_ref`` / ``fused_cross_entropy`` against the Pallas
  ``fused_ce_stats`` (interpret mode) and the JAX ``fused_cross_entropy``
  at the shapes of ``tests/test_kernels.py`` (rtol 1e-5, its bound);
- the CE gradients in hidden and head against ``jax.grad`` of the JAX
  model's ``chunked_cross_entropy``, also with the CE split over
  vocabulary slices (``fused_ce_shard_stats``, the CE under a mesh);
- the backward op's plain version (``fused_ce_bwd_ref``) against
  ``jax.grad`` in the loss form and the statistics' form, at ragged
  shapes, labels outside [0, V), absent coefficients and a transposed
  head; both autograd functions reaching that one op; its fake; the
  kernel's vocab blocks within the plain backward's scratch;
- the attention autograd function's dq, dk, dv against ``jax.grad`` of
  ``blockwise_attention``.

Inputs come from numpy seeds.  f32 cases compare at the bounds stated
with each test; the bf16 cases at a looser one, also stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels.fused_ce.ce import fused_ce_stats as jax_fused_ce_stats
from repro.kernels.fused_ce.ops import fused_cross_entropy as jax_fused_ce
from repro.models.attention import blockwise_attention
from repro.models.model import chunked_cross_entropy as jax_chunked_ce
from repro_torch.kernels.fused_ce import fused_cross_entropy
from repro_torch.kernels.fused_ce.ce import (SCRATCH_ROWS, fused_ce_bwd,
                                             fused_ce_stats, vocab_block,
                                             vocab_splits)
from repro_torch.kernels.fused_ce.ops import fused_ce_shard_stats
from repro_torch.kernels.fused_ce.ref import (BACKWARD_ROWS,
                                              cross_entropy_ref,
                                              fused_ce_bwd_ref,
                                              fused_ce_stats_ref)
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models.model import chunked_cross_entropy


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHAPES = [(100, 64, 500), (256, 128, 1024), (130, 32, 777), (128, 64, 512)]


def _ce_inputs(t, d, v, seed, low=-1):
    """hidden ~ N(0, 1), head ~ 0.05 N(0, 1), labels in [low, v)
    (-1 = ignored), as tests/test_kernels.py draws them."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((t, d), dtype=np.float32)
    w = (0.05 * rng.standard_normal((d, v))).astype(np.float32)
    lab = rng.integers(low, v, (t,), dtype=np.int32)
    return h, w, lab


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("t,d,v", SHAPES)
def test_fused_cross_entropy_matches_jax(t, d, v):
    h, w, lab = _ce_inputs(t, d, v, seed=t + v)
    loss, count = fused_cross_entropy(_t(h), _t(w), _t(lab))
    jl, jc = jax_fused_ce(jnp.asarray(h), jnp.asarray(w), jnp.asarray(lab))
    assert count.item() == float(jc) == float((lab >= 0).sum())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    rl, rc = cross_entropy_ref(_t(h), _t(w), _t(lab))
    assert rc.item() == count.item()
    np.testing.assert_allclose(rl.item(), float(jl), rtol=1e-5)


@pytest.mark.parametrize("t,d,v", [s for s in SHAPES if s[0] % 128 == 0])
def test_fused_ce_stats_ref_matches_pallas(t, d, v):
    """The plain version against the Pallas kernel run in interpret mode
    (which takes T a multiple of 128), labels in [0, V) as the JAX wrapper
    passes them; lse and pick at rtol 1e-5."""
    h, w, lab = _ce_inputs(t, d, v, seed=7 * t, low=0)
    lse, pick = fused_ce_stats_ref(_t(h), _t(w), _t(lab))
    jlse, jpick = jax_fused_ce_stats(jnp.asarray(h), jnp.asarray(w),
                                     jnp.asarray(lab))
    assert lse.shape == pick.shape == (t, 1) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5)
    np.testing.assert_allclose(pick.numpy(), np.asarray(jpick), rtol=1e-5,
                               atol=1e-6)


def test_fused_ce_stats_ref_label_outside_vocab():
    """pick is -1e30 (the kernel's start value) for a label outside [0, V)."""
    h, w, lab = _ce_inputs(8, 32, 40, seed=3, low=0)
    lab[:3] = [-1, 40, 1000]
    _, pick = fused_ce_stats_ref(_t(h), _t(w), _t(lab))
    assert (pick[:3, 0] == -1e30).all() and (pick[3:, 0] > -1e29).all()


def test_fused_cross_entropy_bf16_matches_jax():
    """bf16 hidden and head (test_kernels.py's bf16 case): both sides widen
    to f32 and sum exact products, so only the order of f32 sums differs;
    the bound is test_kernels.py's 2e-2 against the f32 oracle."""
    h, w, lab = _ce_inputs(128, 64, 512, seed=11, low=0)
    hb, wb = _t(h).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    loss, _ = fused_cross_entropy(hb, wb, _t(lab))
    jl, _ = jax_fused_ce(jnp.asarray(h, jnp.bfloat16),
                         jnp.asarray(w, jnp.bfloat16), jnp.asarray(lab))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=2e-2)
    want, _ = cross_entropy_ref(_t(h), _t(w), _t(lab))
    np.testing.assert_allclose(loss.item(), want.item(), rtol=2e-2)


@pytest.mark.parametrize("b,s,d,v,dtype,tol", [
    # f32: the same f32 arithmetic in another order
    (2, 64, 32, 500, "float32", 1e-5),
    (1, 200, 64, 777, "float32", 1e-5),   # ragged: JAX pads to its chunk
    # bf16: JAX's gradient of the bf16 einsum rounds at other places than
    # the port's f32 backward; 2e-2 of the largest gradient entry
    (2, 64, 64, 512, "bfloat16", 2e-2),
])
def test_ce_gradients_match_jax_grad(b, s, d, v, dtype, tol):
    rng = np.random.default_rng(b * s + v)
    h = rng.standard_normal((b, s, d), dtype=np.float32)
    w = (0.05 * rng.standard_normal((d, v))).astype(np.float32)
    lab = rng.integers(-1, v, (b, s), dtype=np.int32)
    tdt = getattr(torch, dtype)

    ht = _t(h).to(tdt).requires_grad_()
    wt = _t(w).requires_grad_()      # f32 master, rounded inside as in JAX
    loss, count = chunked_cross_entropy(ht, wt, _t(lab))
    loss.backward()

    def f(hh, ww):
        return jax_chunked_ce(hh, ww, jnp.asarray(lab))[0]

    jl, (jgh, jgw) = jax.value_and_grad(f, argnums=(0, 1))(
        jnp.asarray(h, getattr(jnp, dtype)), jnp.asarray(w))
    assert count.item() == float((lab >= 0).sum())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=max(tol, 1e-5))
    for got, want in ((ht.grad, jgh), (wt.grad, jgw)):
        assert got.dtype == (tdt if got is ht.grad else torch.float32)
        want = np.asarray(want, np.float32)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                                   rtol=0, atol=tol)


def _combined_shard_ce(h, w, lab, parts):
    """The CE of ``fused_ce_shard_stats`` over ``parts`` equal vocabulary
    slices, each with its labels moved to its start, the slices' lse met
    in a logsumexp and their label logits in a sum, as the model's CE
    under a mesh combines them over "model"."""
    v = w.shape[1] // parts
    stats = [fused_ce_shard_stats(h, w[:, i * v:(i + 1) * v], lab - i * v)
             for i in range(parts)]
    lse = torch.logsumexp(torch.stack([a for a, _ in stats], -1), -1)
    pick = sum(p for _, p in stats)
    mask = (lab >= 0).float()
    return ((lse - pick) * mask).sum()


@pytest.mark.parametrize("parts", [1, 2, 4])
def test_shard_stats_combine_to_jax_ce(parts):
    """Vocabulary slices' (lse, label logit) combined equal JAX's
    ``chunked_cross_entropy``, loss and gradients in hidden and head
    (f32: the same arithmetic in another order, 1e-5 as above)."""
    b, s, d, v = 2, 64, 32, 512
    rng = np.random.default_rng(parts)
    h = rng.standard_normal((b, s, d), dtype=np.float32)
    w = (0.05 * rng.standard_normal((d, v))).astype(np.float32)
    lab = rng.integers(-1, v, (b, s), dtype=np.int32)
    ht, wt = _t(h).requires_grad_(), _t(w).requires_grad_()
    loss = _combined_shard_ce(ht.reshape(-1, d), wt, _t(lab).reshape(-1),
                              parts)
    loss.backward()
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda hh, ww: jax_chunked_ce(hh, ww, jnp.asarray(lab))[0],
        argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for got, want in ((ht.grad, jgh), (wt.grad, jgw)):
        want = np.asarray(want, np.float32)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   rtol=0, atol=1e-5)


def test_ce_gradient_reads_a_transposed_head():
    """Tied embeddings: the head is embed.T, a (d, V) view with strides
    (1, d); the loss and both gradients equal those of a contiguous copy."""
    h, w, lab = _ce_inputs(64, 32, 100, seed=5)
    emb = _t(w.T.copy()).requires_grad_()
    head = emb.T
    assert head.stride() == (1, 32)
    hh = _t(h).requires_grad_()
    loss, _ = fused_cross_entropy(hh, head, _t(lab))
    loss.backward()
    emb2 = _t(w.T.copy()).requires_grad_()
    hh2 = _t(h).requires_grad_()
    loss2, _ = fused_cross_entropy(hh2, emb2.T.contiguous(), _t(lab))
    loss2.backward()
    assert loss.item() == loss2.item()
    torch.testing.assert_close(emb.grad, emb2.grad, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(hh.grad, hh2.grad, rtol=1e-6, atol=1e-7)


def test_fused_ce_stats_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors only: it never takes
    the plain version itself."""
    h, w, lab = _ce_inputs(8, 32, 40, seed=0, low=0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ce_stats(_t(h), _t(w), _t(lab))


@pytest.mark.parametrize("t,v,want", [
    (16384, 50304, 3),   # olmo-1b, splice 1: 128 row tiles, 3 ranges
    (8192, 50304, 5),    # splice 2: 64 row tiles
    (128, 512, 4),       # never more ranges than vocab tiles
])
def test_vocab_splits_fill_the_card(t, v, want):
    """At the kernel's bf16 tile of 128 tokens x 128 vocab columns (the
    library reports it; tests/test_torch_cuda.py checks that on the card)."""
    assert vocab_splits(t, v, (128, 128), sms=132) == want


def _jax_stats_grads(h, w, lab, g_lse, g_pick):
    """jax.grad in hidden and head of sum(g_lse lse) + sum(g_pick pick),
    pick the label's logit (0 outside [0, V)), on the f32 logits."""
    v = w.shape[1]
    inside = (lab >= 0) & (lab < v)

    def f(hh, ww):
        x = hh @ ww
        out = 0.0
        if g_lse is not None:
            out += (jax.nn.logsumexp(x, axis=-1) * g_lse).sum()
        if g_pick is not None:
            pick = jnp.take_along_axis(x, np.where(inside, lab, 0)[:, None],
                                       axis=1)[:, 0]
            out += (jnp.where(inside, pick, 0.0) * g_pick).sum()
        return out

    return jax.grad(f, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))


@pytest.mark.parametrize("form,t,d,v,tied", [
    ("loss", 100, 64, 500, False),
    ("loss", 130, 32, 777, True),       # ragged T and V, head = embed.T
    ("stats", 100, 64, 500, False),     # labels outside [0, V) on both sides
    ("stats", 130, 32, 777, True),
    ("lse only", 64, 32, 300, False),   # g_pick None
    ("pick only", 64, 32, 300, True),   # g_lse None
    ("none", 8, 32, 40, False),         # both None: zeros
])
def test_fused_ce_bwd_ref_matches_jax_grad(form, t, d, v, tied):
    """The backward op's plain version against ``jax.grad``: the loss form
    (g_lse = g mask, g_pick = -g mask, as ``_FusedCrossEntropy`` passes
    them) against JAX's ``chunked_cross_entropy``; the statistics' form
    (``_FusedCEStats``'s coefficients as given) against the gradient of
    g_lse . lse + g_pick . pick.  f32: the same arithmetic in another
    order, 1e-5 of the largest entry."""
    h, w, lab = _ce_inputs(t, d, v, seed=t + v + len(form))
    rng = np.random.default_rng(t)
    if form in ("stats", "none"):
        lab[:3] = [-1, v, v + 5]
    head = _t(w.T.copy()).T if tied else _t(w)
    lse, _ = fused_ce_stats_ref(_t(h), head, _t(lab).clamp(min=0))
    if form == "loss":
        g = 0.25 * (lab >= 0).astype(np.float32)
        g_lse, g_pick = g, -g
        want = jax.grad(lambda hh, ww: 0.25 * jax_chunked_ce(
            hh[None], ww, jnp.asarray(lab)[None])[0],
            argnums=(0, 1))(jnp.asarray(h), jnp.asarray(w))
    else:
        g_lse, g_pick = (rng.standard_normal(t).astype(np.float32)
                         for _ in range(2))
        g_lse = None if form in ("pick only", "none") else g_lse
        g_pick = None if form in ("lse only", "none") else g_pick
        want = _jax_stats_grads(h, w, lab, g_lse, g_pick)
    dh, dw = fused_ce_bwd_ref(_t(h), head, _t(lab), lse,
                              None if g_lse is None else _t(g_lse),
                              None if g_pick is None else _t(g_pick))
    assert (dh.shape, dw.shape) == ((t, d), (d, v))
    assert dh.is_contiguous() and dw.is_contiguous()
    for got, ref in ((dh, want[0]), (dw, want[1])):
        ref = np.asarray(ref, np.float32)
        if form == "none":
            assert not got.any() and not ref.any()
            continue
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy() / scale, ref / scale, rtol=0,
                                   atol=1e-5)


class _Ops(TorchDispatchMode):
    """The ops dispatched inside it, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(str(func))
        return func(*args, **(kwargs or {}))


def test_both_autograd_functions_reach_the_one_op():
    """``_FusedCrossEntropy`` and ``_FusedCEStats`` each run their backward
    through ``repro_torch::fused_ce_bwd``, once, and through no matmul of
    their own."""
    h, w, lab = _ce_inputs(64, 32, 100, seed=9)
    for fn in (lambda hh, ww: fused_cross_entropy(hh, ww, _t(lab))[0],
               lambda hh, ww: sum(x.sum() for x in fused_ce_shard_stats(
                   hh, ww, _t(lab)))):
        hh, ww = _t(h).requires_grad_(), _t(w).requires_grad_()
        out = fn(hh, ww)
        with _Ops() as seen:
            out.backward()
        assert seen.names.count("repro_torch.fused_ce_bwd.default") == 1
        assert not [n for n in seen.names if "mm" in n.split(".")[1]]
        assert hh.grad.abs().sum() > 0 and ww.grad.abs().sum() > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ce_bwd_fake(dtype):
    """On fake tensors the op gives new contiguous (dh (T, d), dW (d, V))
    in hidden's and head's dtype, also for a transposed head."""
    mode = FakeTensorMode()
    with mode:
        h = torch.empty(300, 64, dtype=dtype)
        head = torch.empty(777, 64, dtype=dtype).T
        lab = torch.zeros(300, dtype=torch.long)
        lse = torch.empty(300, 1)
        dh, dw = torch.ops.repro_torch.fused_ce_bwd(h, head, lab, lse,
                                                    lse[:, 0], None)
    assert (dh.shape, dh.dtype, dh.stride()) == ((300, 64), dtype, (64, 1))
    assert (dw.shape, dw.dtype, dw.stride()) == ((64, 777), dtype, (777, 1))


@pytest.mark.parametrize("need_dh,need_dw", [(True, False), (False, True),
                                             (False, False)])
def test_fused_ce_bwd_skips_outputs_not_needed(need_dh, need_dw):
    """An output not needed comes back empty, (0,), on the plain version
    and the fake alike; the other equals the one both give, to the bit."""
    h, w, lab = _ce_inputs(100, 32, 300, seed=4)
    args = (_t(h), _t(w), _t(lab))
    lse, _ = fused_ce_stats_ref(*args)
    g = _t(np.random.default_rng(4).standard_normal(100).astype(np.float32))
    both = fused_ce_bwd_ref(*args, lse, g, -g)
    got = torch.ops.repro_torch.fused_ce_bwd(*args, lse, g, -g, need_dh,
                                             need_dw)
    with FakeTensorMode() as mode:
        fake = torch.ops.repro_torch.fused_ce_bwd(
            *(mode.from_tensor(x) for x in (*args, lse, g)), None, need_dh,
            need_dw)
    for need, out, full, f in zip((need_dh, need_dw), got, both, fake):
        assert f.shape == out.shape == (full.shape if need else (0,))
        assert not need or torch.equal(out, full)


def test_autograd_asks_only_for_the_gradients_it_needs():
    """With the head frozen the op is asked for dh alone, and with hidden
    frozen for dW alone; the gradient given equals the one of a call that
    needs both, to the bit."""
    h, w, lab = _ce_inputs(64, 32, 100, seed=5)

    class _Flags(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "fused_ce_bwd" in str(func):
                # the dispatcher leaves trailing defaults (True) out
                self.flags = (*args[6:], True, True)[:2]
            return func(*args, **(kwargs or {}))

    def grads(need_h, need_w):
        hh = _t(h).requires_grad_(need_h)
        ww = _t(w).requires_grad_(need_w)
        loss = fused_cross_entropy(hh, ww, _t(lab))[0]
        with _Flags() as seen:
            loss.backward()
        return seen.flags, hh.grad, ww.grad

    _, dh, dw = grads(True, True)
    flags, dh_only, no_dw = grads(True, False)
    assert flags == (True, False) and no_dw is None
    assert torch.equal(dh_only, dh)
    flags, no_dh, dw_only = grads(False, True)
    assert flags == (False, True) and no_dh is None
    assert torch.equal(dw_only, dw)


def test_fused_ce_bwd_ref_takes_the_rows_in_blocks():
    """Past ``BACKWARD_ROWS`` rows the plain backward recomputes the logits
    a block at a time: dh and dW equal the whole-logits gradients (f32,
    dW summed over the blocks in another order: 1e-6 of its largest
    entry)."""
    t = 2 * BACKWARD_ROWS + 5
    h, w, lab = _ce_inputs(t, 32, 64, seed=6)
    hh, ww = _t(h), _t(w)
    lse, _ = fused_ce_stats_ref(hh, ww, _t(lab).clamp(min=0))
    g = (_t(lab) >= 0).float() / t
    dh, dw = fused_ce_bwd_ref(hh, ww, _t(lab), lse, g, -g)
    p = torch.softmax(hh @ ww, dim=-1) * g[:, None]
    p.scatter_add_(1, _t(lab).long().clamp(min=0)[:, None], -g[:, None])
    for got, want in ((dh, p @ ww.T), (dw, hh.T @ p)):
        scale = want.abs().max()
        torch.testing.assert_close(got / scale, want / scale, rtol=0,
                                   atol=1e-6)


def test_fused_ce_bwd_wrapper_refuses_cpu_tensors():
    h, w, lab = _ce_inputs(8, 32, 40, seed=0, low=0)
    hb, wb = _t(h).to(torch.bfloat16), _t(w).to(torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_ce_bwd(hb, wb, _t(lab), torch.zeros(8, 1), None, None)


@pytest.mark.parametrize("t,v,want", [
    (16384, 50304, 5632),    # olmo-1b at splice 1: 9 blocks
    (4096, 50304, 16896),    # at splice 4: 3 blocks
    (16384, 49155, 5632),    # granite-moe: 9 blocks
    (16384, 100352, 12544),  # granite-4.0-h-micro: 8 blocks
    (300, 777, 1024),        # one block of whole tiles
])
def test_vocab_block_keeps_the_scratch(t, v, want):
    """Blocks of whole 256-column tiles, as few as keep p's two bf16 planes
    (4 T c bytes) within SCRATCH_ROWS rows of f32 logits (4 rows V
    bytes)."""
    c = vocab_block(t, v, 256)
    blocks = -(-v // c)
    assert c == want and c % 256 == 0
    assert 4 * t * -(-c // 8) * 8 <= 4 * SCRATCH_ROWS * v or blocks == 1
    assert blocks == 1 or vocab_block(t, v, 256) * (blocks - 1) < v


@pytest.mark.parametrize("b,s,h,d,window,dtype,tol", [
    # f32: the same softmax, recomputed, in another order of sums
    (2, 48, 4, 32, 0, "float32", 1e-5),
    (1, 70, 2, 64, 24, "float32", 1e-5),
    # bf16: blockwise_attention scales q in bf16 and rounds its blocks'
    # products at other places than the port's f32 recomputation; 3e-2 of
    # the largest gradient entry
    (2, 48, 4, 32, 0, "bfloat16", 3e-2),
])
def test_attention_gradients_match_jax_grad(b, s, h, d, window, dtype, tol):
    rng = np.random.default_rng(s + window)
    q, k, v, do = (rng.standard_normal((b, s, h, d), dtype=np.float32)
                   for _ in range(4))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    qt, kt, vt = (_t(x).to(tdt).requires_grad_() for x in (q, k, v))
    out = swa_attention(qt, kt, vt, window=window)
    out.backward(_t(do).to(tdt))

    def f(qq, kk, vv):
        o = blockwise_attention(qq, kk, vv, causal=True, window=window)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(do))

    grads = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    for got, want in zip((qt.grad, kt.grad, vt.grad), grads):
        assert got.dtype == tdt and got.shape == (b, s, h, d)
        want = np.asarray(want, np.float32)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.float().numpy() / scale, want / scale,
                                   rtol=0, atol=tol)
