"""The port's dry-run planner (``launch/dryrun.py::lower_pair``) on the CPU
at smoke size: each trace joins a fake world of the mesh's size, runs the
step on DTensors of fake tensors and counts rank 0's ops
(``analysis/op_cost.py``).

- the train step of all six families on a (2, 2) mesh, prefill and decode
  of olmo-1b and granite-moe (10 traces), and the donated olmo-1b and
  granite-moe train steps on (1, 1) (``lower_smoke``: B 8 x S 64, in
  four processes): records with their keys; no process group is left
  behind, after a trace or a failed one;
- per-device counts: a matmul split over both axes of a (2, 2) mesh counts
  a quarter of the (1, 1) FLOPs, one replicated over "model" a half;
- collective bytes 0 on (1, 1), nonzero on (2, 2); the donated state's
  bytes as ``alias_size_in_bytes``;
- the olmo smoke step's FLOPs against JAX's ``analyze_hlo`` of its
  one-device lowering, and ``model_flops`` against JAX's.
"""
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from repro.analysis.hlo_cost import analyze_hlo
from repro.analysis.roofline import model_flops as jax_model_flops
from repro.configs import ASSIGNED_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import INPUT_SHAPES
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.launch.specs import state_specs as jax_state_specs
from repro.training.step import build_train_step as jax_build_train_step
from repro_torch.analysis import report
from repro_torch.analysis.op_cost import OpCost
from repro_torch.analysis.roofline import model_flops
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun_all
from repro_torch.launch.dryrun import lower_pair, lower_smoke
from repro_torch.launch.hillclimb import variant_kwargs

FAMILIES = ["olmo-1b", "granite-moe-3b-a800m", "mamba2-130m", "zamba2-1.2b",
            "whisper-base", "llama-3.2-vision-11b"]
G, S = 8, 64
TRACES = ([(arch, "train", (2, 2), False) for arch in FAMILIES]
          + [(arch, kind, (2, 2), False)
             for arch in ("olmo-1b", "granite-moe-3b-a800m")
             for kind in ("prefill", "decode")]
          + [(arch, "train", (1, 1), True)
             for arch in ("olmo-1b", "granite-moe-3b-a800m")])
KEYS = {"arch", "shape", "mesh", "status", "chips", "splice", "swa_variant",
        "trace_seconds", "memory", "op_cost", "roofline", "param_count",
        "active_param_count", "aten_ops"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "bytes_per_device"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def records():
    """The traces, in four spawned processes (a trace's time is mostly
    DTensor's first propagation of each op and placement)."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(4, mp_context=ctx) as pool:
        recs = list(pool.map(lower_smoke, *zip(*TRACES)))
    return dict(zip(TRACES, recs))


@pytest.mark.parametrize("case", TRACES, ids=lambda c: "-".join(
    [c[0], c[1], "x".join(map(str, c[2]))] + (["donate"] if c[3] else [])))
def test_trace(records, case):
    rec = records[case]
    assert rec["status"] == "ok" and KEYS <= set(rec), rec
    assert MEMORY_KEYS == set(rec["memory"])
    assert rec["chips"] == case[2][0] * case[2][1]
    mem, cost = rec["memory"], rec["op_cost"]
    assert cost["flops"] > 0 and cost["bytes"] > 0
    assert mem["bytes_per_device"] >= mem["argument_size_in_bytes"] > 0
    assert mem["bytes_per_device"] == (
        mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
        + mem["temp_size_in_bytes"] - mem["alias_size_in_bytes"])
    rf = rec["roofline"]
    assert rf["dominant"] in ("compute", "memory", "collective")
    assert rf["compute_s"] > 0 and rf["memory_s"] > 0
    if case[2] == (1, 1):
        assert cost["coll_bytes"] == 0 and rf["collective_s"] == 0
    else:
        assert cost["coll_bytes"] > 0 and rf["collective_s"] > 0
    json.dumps(rec)


def test_donated_state_is_aliased(records):
    """(1, 1), donated: the aliased bytes are the whole state, which is
    the arguments less the batch's tokens and labels (int64)."""
    for arch in ("olmo-1b", "granite-moe-3b-a800m"):
        mem = records[(arch, "train", (1, 1), True)]["memory"]
        batch_bytes = 2 * G * S * 8
        assert mem["alias_size_in_bytes"] == \
            mem["argument_size_in_bytes"] - batch_bytes
        # the results: the state and three f32 metrics
        assert mem["output_size_in_bytes"] == mem["alias_size_in_bytes"] + 12


def _matmul_flops(mesh_shape, w_placement):
    """Per-device FLOPs of x @ w on a fake mesh: x (64, 32) over "data" on
    its rows, w (32, 16) by ``w_placement``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import MeshShape, make_mesh

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh_shape[0] * mesh_shape[1])
    try:
        mesh = make_mesh(MeshShape(("data", "model"), mesh_shape))
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(64, 32), mesh,
                                  [Shard(0), Replicate()])
            w = distribute_tensor(torch.empty(32, 16), mesh,
                                  [Replicate(), w_placement(Shard, Replicate)])
            with OpCost() as counter:
                x @ w
    finally:
        dist.destroy_process_group()
    return counter.cost.flops


def test_per_device_counts():
    """Split over both axes (rows over "data", columns over "model"): a
    quarter of the one-device count; w replicated over "model", so every
    device of a "model" row does the same work: a half."""
    def both(shard, _rep):
        return shard(1)

    def rows_only(_shard, rep):
        return rep()

    one = _matmul_flops((1, 1), both)
    assert one == 2 * 64 * 32 * 16
    assert _matmul_flops((2, 2), both) == one / 4
    assert _matmul_flops((2, 2), rows_only) == one / 2


def test_flops_match_jax_one_device():
    """The olmo smoke train step at batch 2 x 512 on one device, remat on:
    the port's count is JAX's ``analyze_hlo`` count plus exactly two
    recompute terms, less exactly the masked products the kernels skip.

    At S = 512 JAX's 512-blocks and 128-token CE chunks pad nothing, so the
    two run the same products: per layer q/k/v/o projections and the MLP
    forward twice (remat) and backward, the tied head's logits and their
    two gradient products, and for attention 2 forward products (Q·Kᵀ,
    P·V), 2 again under remat and 4 backward (dP, dV, dS·K, dSᵀ·Q), each
    on the whole S².  The port's attention backward is the
    ``repro_torch::swa_flash_bwd`` op, counted by its formula: those 4
    products and a recomputed Q·Kᵀ, all over the causal pairs S(S+1)/2 =
    131,328.  The recompute adds 2 layers x 2·B·H·D·S(S+1)/2 =
    2 x 2·2·4·64·131,328 = 268,959,744 FLOPs.  The CE under a mesh
    (``fused_ce_shard_stats``) keeps (lse, label logit) and not the
    logits, so its backward recomputes them: 2·T·d·V = 2·1024·256·512 =
    268,435,456 FLOPs.  The forward attention is the
    ``repro_torch::swa_flash`` op, counted by its formula over the causal
    pairs: each of its 4 forward calls (2 layers, again under remat) does
    4·B·H·D·(S² - S(S+1)/2) = 4·2·4·64·130,816 = 267,911,168 FLOPs fewer
    than JAX's, and each of the 2 backward calls 8·B·H·D·(S² - S(S+1)/2)
    = 535,822,336 fewer: 2,143,289,344 in all.  Bound: those terms
    exactly, to 1e-6 of JAX's count."""
    seq, batch = 512, 2
    cfg = jax_smoke_config("olmo-1b")
    tcfg = JaxTrainConfig()
    jbatch = {k: jax.ShapeDtypeStruct((batch, seq), jnp.int32)
              for k in ("tokens", "labels")}
    hlo = jax.jit(jax_build_train_step(cfg, tcfg)).lower(
        jax_state_specs(cfg, tcfg), jbatch).compile().as_text()
    want = analyze_hlo(hlo).flops
    rec = lower_smoke("olmo-1b", "train", (1, 1), False, seq, batch)
    assert not dist.is_initialized()
    per_pair = batch * cfg.num_heads * cfg.resolved_head_dim()
    pairs = seq * (seq + 1) // 2
    attention = cfg.num_layers * 2 * per_pair * pairs
    logits = 2 * batch * seq * cfg.d_model * cfg.vocab_size
    masked = cfg.num_layers * (2 * 4 + 8) * per_pair * (seq ** 2 - pairs)
    assert (attention, logits, masked) == (268_959_744, 268_435_456,
                                           2_143_289_344)
    assert rec["kernel_ops"]["swa_flash"] == 2 * cfg.num_layers
    assert rec["kernel_ops"]["swa_flash_bwd"] == cfg.num_layers
    assert abs(rec["op_cost"]["flops"]
               - (want + attention + logits - masked)) <= 1e-6 * want


def test_model_flops_equal_jax():
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            assert model_flops(get_config(arch), shape) == \
                jax_model_flops(jax_get_config(arch), shape)


def test_lower_pair_leaves_no_world():
    """A failing trace (a batch of 8 does not split into 3 slices) still
    destroys the fake world it made."""
    with pytest.raises(ValueError, match="does not split"):
        lower_pair("olmo-1b", "train_4k", False, splice=3,
                   mesh_override=(1, 1), config=get_smoke_config("olmo-1b"),
                   shape_config=ShapeConfig("s", S, G, "train"))
    assert not dist.is_initialized()


def test_hillclimb_variants():
    kw = variant_kwargs("donate+splice4+nomodeltp+cf150+chips64+dotsremat")
    assert kw["donate"] and kw["splice"] == 4
    assert kw["shard_profile"] == "replicate_model"
    assert kw["moe_capacity_factor"] == 1.5
    assert kw["mesh_override"] == (16, 4)
    assert kw["remat_policy"] == "dots"
    assert variant_kwargs("noremat+fusedgate+chips8")["mesh_override"] == \
        (8, 1)
    with pytest.raises(ValueError):
        variant_kwargs("bogus")


def test_tables(records, tmp_path, monkeypatch, capsys):
    """``dryrun_all --table`` and ``report`` read the records back."""
    rec = dict(records[("olmo-1b", "train", (2, 2), False)])
    rec.update(arch="olmo-1b", shape="train_4k", mesh="single")
    monkeypatch.setattr(dryrun_all, "RESULTS", str(tmp_path))
    monkeypatch.setattr(report, "RESULTS", str(tmp_path))
    with open(dryrun_all.result_path("olmo-1b", "train_4k", "single"),
              "w") as f:
        json.dump(rec, f)
    dryrun_all.print_table()
    assert "olmo-1b  train_4k" in capsys.readouterr().out
    text = report.table()
    assert "| olmo-1b | train_4k | single | 4 |" in text
    assert "MISSING" in text
