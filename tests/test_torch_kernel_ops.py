"""The five kernels as ``torch.library`` ops (``repro_torch/kernels/
_library.py``) on the CPU, where no kernel runs: the CPU implementation is
the plain version and the fake one gives the kernel's output metadata.

- ``torch.library.opcheck`` of each op on CPU inputs (schema, fake
  tensors); each fake output's shape, dtype and strides equal to the CPU
  implementation's;
- each op's formula: ``fused_ce_stats``'s FLOPs equal to what ``OpCost``
  counts for its plain version; ``ssd_intra_chunk``'s equal to that less
  the two masked Q x Q products' upper triangle, which the plain version
  computes and the kernel does not; ``swa_flash`` at 4 D pairs B H and
  ``swa_flash_bwd`` at 10 D pairs B H with the exact causal (windowed)
  pairs; the bounds ``chip_smoke.py`` prints equal to its formulas before
  they moved into the package;
- the planner traces the kernel path: an olmo smoke prefill on (1, 1)
  counts one ``swa_flash`` a layer and no softmax, and the attention core's
  live bytes on fake tensors grow as S, not S^2;
- ``bytes_lower`` at most ``bytes``, and equal to a hand count.

No JAX: the ops' CPU implementations are the plain versions that the other
``test_torch_*`` files hold against the JAX package.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.analysis.op_cost import OpCost
from repro_torch.configs import get_smoke_config
from repro_torch.kernels._library import COSTS
from repro_torch.kernels.checksum import ops as fp_ops
from repro_torch.kernels.fused_ce import ops as ce_ops
from repro_torch.kernels.fused_ce.ref import fused_ce_stats_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
from repro_torch.kernels.swa_attention import ops as swa_ops
from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.launch.dryrun import lower_smoke
from repro_torch.utils import constants

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name):
    """Smoke-size CPU arguments of each op, drawn with numpy from seed 0."""
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    if name == "swa_flash":
        return (randn(2, 24, 2, 16), randn(2, 24, 2, 16), randn(2, 24, 2, 16),
                8)
    if name == "swa_flash_bwd":
        q, k, v = (randn(2, 24, 2, 16).to(torch.bfloat16) for _ in range(3))
        o, lse = swa_ops._plain(q, k, v, 8)
        return q, k, v, o, randn(2, 24, 2, 16).to(torch.bfloat16), lse, 8
    if name == "ssd_intra_chunk":
        return (randn(3, 16, 2, 16), torch.nn.functional.softplus(
            randn(3, 16, 2)), -torch.exp(0.1 * randn(2)), randn(3, 16, 8),
            randn(3, 16, 8))
    if name == "fused_ce_stats":
        labels = torch.from_numpy(rng.integers(-1, 40, 10))
        return randn(10, 32), 0.02 * randn(32, 40), labels
    return (fp_ops._flat_words(randn(1000)),)


OPS = ["swa_flash", "swa_flash_bwd", "ssd_intra_chunk", "fused_ce_stats",
       "fingerprint_u32"]


def _op(name):
    return getattr(torch.ops.repro_torch, name).default


@pytest.mark.parametrize("name", OPS)
def test_opcheck(name):
    """Schema (no argument mutated or aliased) and fake tensors, on CPU
    inputs."""
    torch.library.opcheck(_op(name), _inputs(name),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("name", OPS)
def test_fake_matches_cpu(name):
    """The fake implementation's outputs have the CPU implementation's
    shapes, dtypes and strides (the kernel's: new contiguous tensors)."""
    args = _inputs(name)
    real = _op(name)(*args)
    mode = FakeTensorMode()
    fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                 for a in args]
    with mode:
        fake = _op(name)(*fake_args)
    real = real if isinstance(real, tuple) else (real,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert len(real) == len(fake)
    for r, f in zip(real, fake):
        assert (f.shape, f.dtype, f.stride()) == (r.shape, r.dtype,
                                                  r.stride())
        assert r.is_contiguous()


def test_meta_takes_the_fake():
    q = torch.empty(1, 8, 1, 8, device="meta")
    out, lse = _op("swa_flash")(q, q, q, 0)
    assert out.device.type == "meta" and out.shape == q.shape
    assert lse.device.type == "meta" and lse.shape == (1, 1, 8)
    assert lse.dtype == torch.float32


@pytest.mark.parametrize("name", OPS)
def test_cuda_implementation_has_no_fallback(name):
    """The op's CUDA implementation is the kernel's wrapper, which raises on
    a tensor that is not on a CUDA device instead of taking the plain
    version."""
    module = {"swa_flash": swa_ops, "swa_flash_bwd": swa_ops,
              "ssd_intra_chunk": ssd_ops, "fused_ce_stats": ce_ops,
              "fingerprint_u32": fp_ops}[name]
    kernel = swa_ops._bwd_kernel if name == "swa_flash_bwd" else \
        module._kernel
    with pytest.raises(ValueError, match="CUDA"):
        kernel(*_inputs(name))


def _counted(fn, *args):
    with OpCost() as counter:
        fn(*args)
    return counter


def test_ce_formula_equals_plain_count():
    args = _inputs("fused_ce_stats")
    t, d = args[0].shape
    v = args[1].shape[1]
    want = ce_ops.fused_ce_stats_cost(t, d, v, 4)
    assert _counted(fused_ce_stats_ref, *args).cost.flops == want.flops
    assert _counted(_op("fused_ce_stats"), *args).cost.flops == want.flops


def test_ssd_formula_equals_plain_count():
    """The plain version runs C B^T and M x over the whole Q x Q; the
    kernel (and its formula) over the causal pairs only."""
    args = _inputs("ssd_intra_chunk")
    bc, q, h, p = args[0].shape
    n = args[3].shape[-1]
    want = ssd_ops.ssd_intra_chunk_cost(bc, q, h, p, n, 4)
    masked = 2 * bc * (n + h * p) * (q * q - q * (q + 1) // 2)
    assert _counted(ssd_intra_chunk_ref, *args).cost.flops == \
        want.flops + masked
    assert _counted(_op("ssd_intra_chunk"), *args).cost.flops == want.flops


@pytest.mark.parametrize("s,window", [(24, 0), (24, 8), (24, 24), (24, 40),
                                      (1, 0)])
def test_swa_formula(s, window):
    """4 D pairs B H, the pairs counted by brute force over the mask."""
    b, h, d = 2, 3, 16
    pairs = sum(min(i + 1, window) if window > 0 else i + 1
                for i in range(s))
    assert swa_ops.causal_pairs(s, window) == pairs
    q = torch.zeros(b, s, h, d)
    cost = _counted(_op("swa_flash"), q, q, q, window).cost
    assert cost.flops == 4 * d * pairs * b * h
    assert cost.bytes == cost.bytes_lower == 4 * b * s * h * d * 4


@pytest.mark.parametrize("s,window", [(24, 0), (24, 8), (24, 24), (24, 40),
                                      (1, 0)])
def test_swa_bwd_formula(s, window):
    """10 D pairs B H: the five products (Q K^T again, dP, dV, dK, dQ)
    over the pairs counted by brute force over the mask; 8 bf16 tensors of
    B S H D and the f32 log-sum-exp read or written once."""
    b, h, d = 2, 3, 16
    pairs = sum(min(i + 1, window) if window > 0 else i + 1
                for i in range(s))
    q = torch.zeros(b, s, h, d, dtype=torch.bfloat16)
    lse = torch.zeros(b, h, s)
    cost = _counted(_op("swa_flash_bwd"), q, q, q, q, q, lse, window).cost
    assert cost.flops == 10 * d * pairs * b * h
    assert cost.bytes == 8 * b * s * h * d * 2 + 4 * b * h * s


def test_swa_bwd_formula_is_the_plain_count_on_the_pairs():
    """The plain backward runs its five products on the whole S x S square
    (``OpCost`` counts them); the formula counts the same five on the
    causal pairs only."""
    b, s, h, d = 2, 24, 3, 16
    q = torch.randn(b, s, h, d)
    plain = _counted(swa_ops.swa_attention_bwd_ref, q, q, q, q, 0).cost
    assert plain.flops == 10 * d * s * s * b * h
    assert swa_ops.swa_flash_bwd_cost(b, s, h, d, 0, 2).flops == \
        plain.flops * swa_ops.causal_pairs(s, 0) // (s * s)


def _old_bounds(torch, case):
    """``chip_smoke.py``'s bound formulas as they were written there before
    they moved beside the ops: (ms, bound_by)."""
    def peak(dtype):
        return {torch.bfloat16: constants.DATASHEET_PEAK_BF16_FLOPS,
                torch.float32: constants.DATASHEET_PEAK_F32_FLOPS}[dtype]

    def bound(t_bytes, t_ops):
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    hbm = constants.DATASHEET_HBM_BANDWIDTH
    kind, args = case
    if kind == "swa":
        b, s, h, d, window, dtype = args
        el = torch.empty((), dtype=dtype).element_size()
        pairs = (s * (s + 1) // 2 if window <= 0
                 else sum(min(i + 1, window) for i in range(s)))
        return bound(4 * b * s * h * d * el / hbm,
                     4 * d * pairs * b * h / peak(dtype))
    if kind == "ssd":
        bc, q, h, p, n, dtype = args
        el = torch.empty((), dtype=dtype).element_size()
        read = el * bc * q * (h * p + 2 * n) + 4 * (bc * q * h + h)
        written = 4 * (bc * q * h * p + bc * h * p * n + bc * q * h)
        pairs = q * (q + 1) // 2
        flops = 2 * bc * (n * pairs + h * p * pairs + h * q * p * n)
        return bound((read + written) / hbm, flops / peak(dtype))
    if kind == "ce":
        t, d, v, dtype = args
        el = torch.empty((), dtype=dtype).element_size()
        return bound((el * (t * d + d * v) + 4 * t + 8 * t) / hbm,
                     2 * t * d * v / peak(dtype))
    n_words, padded = args
    return bound((4 * n_words + 16) / hbm,
                 10 * padded / constants.DATASHEET_INT32_OPS)


def test_chip_smoke_bounds_unchanged():
    """Every timed shape of ``chip_smoke.py``: the bound it now computes
    from the ops' formulas equals the one its own formulas gave."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    checked = 0
    for (b, s, h, d, w, dname), _, _ in cs.SWA_TIMED:
        dtype = getattr(torch, dname)
        assert cs.attention_bound(torch, b, s, h, d, w, dtype) == \
            _old_bounds(torch, ("swa", (b, s, h, d, w, dtype)))
        checked += 1
    for (bc, q, h, p, n, dname), _ in cs.SSD_TIMED:
        dtype = getattr(torch, dname)
        assert cs.ssd_bound(torch, bc, q, h, p, n, dtype) == \
            _old_bounds(torch, ("ssd", (bc, q, h, p, n, dtype)))
        checked += 1
    for (t, d, v, dname, _), _ in cs.CE_TIMED:
        dtype = getattr(torch, dname)
        assert cs.ce_bound(torch, t, d, v, dtype) == \
            _old_bounds(torch, ("ce", (t, d, v, dtype)))
        checked += 1
    for shape in cs.FP_TIMED:
        n = int(np.prod(shape))
        padded = fp_ops.padded_words(n)
        assert cs.fingerprint_bound(n) == \
            _old_bounds(torch, ("fp", (n, padded)))
        checked += 1
    assert checked >= 4


def test_prefill_traces_the_kernel():
    """The olmo smoke prefill on (1, 1): one ``swa_flash`` op a layer, no
    softmax (the plain version's is gone from the trace)."""
    cfg = get_smoke_config("olmo-1b")
    rec = lower_smoke("olmo-1b", "prefill", (1, 1), False, 64, 4)
    assert rec["status"] == "ok"
    assert rec["kernel_ops"] == {"swa_flash": cfg.num_layers}
    assert rec["aten_ops"]["swa_flash"] == cfg.num_layers
    assert not any("softmax" in name for name in rec["aten_ops"])
    assert not torch.distributed.is_initialized()


def _core_temp(s: int) -> int:
    """Peak live bytes less the arguments of the causal attention core on
    fake (1, s, 4, 16) f32 q, k, v."""
    with FakeTensorMode():
        q, k, v = (torch.empty(1, s, 4, 16) for _ in range(3))
        counter = OpCost()
        args = counter.track([q, k, v])
        with counter:
            swa_attention(q, k, v, window=0)
    return counter.peak_bytes - args


def test_core_memory_grows_as_s():
    """The kernel holds its output only: doubling S doubles (peak -
    arguments).  The plain version's (S, S) scores, their masked copy and
    their softmax would quadruple it."""
    small, large = _core_temp(256), _core_temp(512)
    assert small > 0
    assert large <= 2.2 * small


def test_bytes_lower_hand_count():
    """y = x @ w (a matmul: operands + result), z = relu(y) (2 x result),
    z.T (a view: nothing), z.sum() (2 x result)."""
    x, w = torch.ones(4, 8), torch.ones(8, 16)
    with OpCost() as counter:
        z = torch.relu(x @ w)
        z.T.sum()
    want = (4 * 8 + 8 * 16 + 4 * 16) * 4 + 2 * 4 * 16 * 4 + 2 * 4
    assert counter.cost.bytes_lower == want
    assert counter.cost.bytes_lower <= counter.cost.bytes
    # bytes counts operands + results of every non-view op
    assert counter.cost.bytes == (4 * 8 + 8 * 16 + 4 * 16) * 4 + \
        2 * 4 * 16 * 4 + (4 * 16 + 1) * 4


def test_costs_registered():
    assert set(COSTS) == set(OPS)
