"""The two cells of granite-4.0-h-micro and olmo-1b at S 1024: found by
name and built into the port's configs; the SSD's cost formulas; and the
readers of the Mamba2 mixer's spans and of the SSD's roofline shares
against traces built by hand."""
from __future__ import annotations

import pytest

from _smoke import ROOT  # noqa: F401  (puts the checkout on sys.path)
from bench import costs, costs_ssd, harness, trace as trace_lib

CELL = "granite-h-micro-train-s1"
SSD_METRICS = ("ssm_mixer_ms.train", "ssm_scan_ms.train",
               "ssd_intra_roofline.train", "ssd_bwd_roofline.train")
GENERIC = ("step_mfu.train", "attn_bwd_roofline.train",
           "swa_flash_roofline.train", "fused_ce_roofline.train",
           "device_idle_share.train", "kernels_per_step.train",
           "grad_sum_ms.train", "slice_idle_ms.train",
           "boundary_idle_ms.train")


def test_both_cells_load_and_build_the_ports_configs():
    from repro_torch.configs.base import ModelConfig, SSMConfig

    g = harness.load_cell(CELL)
    cfg, tcfg = harness.program_config(g)
    assert isinstance(cfg, ModelConfig) and isinstance(cfg.ssm, SSMConfig)
    assert (cfg.arch_type, cfg.num_layers, cfg.d_model, cfg.num_heads,
            cfg.num_kv_heads, cfg.d_ff, cfg.vocab_size) == (
        "interleaved", 40, 2048, 32, 8, 8192, 100352)
    assert cfg.ssm == SSMConfig(state_dim=128, head_dim=64, expand=2,
                                chunk_size=128, conv_width=4)
    assert isinstance(cfg.layer_types, tuple) and len(cfg.layer_types) == 40
    assert cfg.rope_theta == 0.0 and cfg.tie_embeddings
    assert (g.splice, g.rows_per_slice, g.tokens_per_step) == (1, 4, 16384)
    assert g.job["donate"] and g.job["check_steps"] == 2
    assert [m["name"] for m in g.per_layer] == [*GENERIC, *SSD_METRICS]
    hash(cfg)
    assert tcfg.remat and tcfg.remat_policy == "full"

    s = harness.load_cell("olmo1b-train-seq1k")
    cfg, _ = harness.program_config(s)
    assert cfg == harness.program_config(
        harness.load_cell("olmo1b-train-s1"))[0]
    assert (s.splice, s.rows_per_slice, s.tokens_per_step) == (1, 16, 16384)
    assert s.traffic["seq_len"] == 1024
    assert [m["name"] for m in s.per_layer] == list(GENERIC)


def test_the_configuration_holds_the_published_config():
    """The file's top-level keys are the published config's, each with
    its value, but the one cut, ``mamba_chunk_size`` 256 -> 128, which
    ``reduced`` names and the program runs."""
    conf = harness.load_cell(CELL).config
    published = conf["published"]
    changed = {k for k, v in published.items() if conf[k] != v}
    assert changed == set(conf["reduced"]) == {"mamba_chunk_size"}
    assert (published["mamba_chunk_size"], conf["mamba_chunk_size"]) == (
        256, 128)
    assert conf["model"]["ssm"]["chunk_size"] == conf["mamba_chunk_size"]
    assert conf["reference"]["ssd_chunk"] == published["mamba_chunk_size"]
    m = conf["model"]
    assert m["layer_types"] == published["layer_types"]
    assert (m["embedding_multiplier"], m["attention_multiplier"],
            m["residual_multiplier"], m["logits_scaling"], m["norm_eps"]) \
        == (published["embedding_multiplier"],
            published["attention_multiplier"],
            published["residual_multiplier"], published["logits_scaling"],
            published["rms_norm_eps"])


def test_ssd_costs_by_hand():
    """At the cell's call (BC 128 chunks of 128, 64 heads of 64, state
    128, bf16 x, B, C): the forward's products and bytes, and the
    backward's twice the operations and its reads and writes."""
    bc, q, h, p, n = costs_ssd.ssd_call(
        harness.load_cell(CELL).config["model"], 4, 4096)
    assert (bc, q, h, p, n) == (128, 128, 64, 64, 128)
    pairs = 128 * 129 // 2
    flops = 2 * 128 * (128 * pairs + 64 * 64 * pairs + 64 * 128 * 64 * 128)
    inputs = 2 * 128 * 128 * (64 * 64 + 2 * 128) + 4 * (128 * 128 * 64 + 64)
    outputs = 4 * (128 * 128 * 64 * 64 + 128 * 64 * 64 * 128
                   + 128 * 128 * 64)
    fwd = costs_ssd.ssd_intra_chunk_cost(bc, q, h, p, n)
    bwd = costs_ssd.ssd_intra_chunk_bwd(bc, q, h, p, n)
    assert fwd == costs.Work(flops, inputs + outputs)
    assert bwd == costs.Work(2 * flops, 2 * inputs + outputs)
    # both bound by bytes at this call
    assert fwd.bound_s() == (inputs + outputs) / costs.PEAK_HBM_BYTES
    assert bwd.bound_s() == (2 * inputs + outputs) / costs.PEAK_HBM_BYTES
    # a sequence that is no whole number of chunks is padded
    model = dict(harness.load_cell(CELL).config["model"])
    assert costs_ssd.ssd_call(model, 2, 300)[0] == 2 * 3


def test_the_frozen_copy_equals_the_ops_formula_today():
    from repro_torch.kernels.ssd_scan.ops import ssd_intra_chunk_cost

    for shape in ((128, 128, 64, 64, 128), (3, 64, 5, 32, 16)):
        for elsize in (2, 4):
            mine = costs_ssd.ssd_intra_chunk_cost(*shape, elsize)
            theirs = ssd_intra_chunk_cost(*shape, elsize)
            assert (mine.flops, mine.bytes) == (theirs.flops, theirs.bytes)


# one traced step of the cell: 36 Mamba2 layers, each mixer's span in the
# forward and in its recompute (72), its scan inside it, the kernel's 72
# calls and the backward node's 36
OPS = {"ssm.mixer": trace_lib.OpTime(72, 0.55, 0.0),
       "ssm.scan": trace_lib.OpTime(72, 0.16, 0.0),
       "repro_torch::ssd_intra_chunk": trace_lib.OpTime(72, 0.034, 0.034),
       "_SsdIntraChunkBackward": trace_lib.OpTime(36, 0.63, 0.0)}


def _read(name, tr, cell=CELL):
    run = harness.Run(harness.load_cell(cell), [3.4], tr, 31.0)
    return harness.metric_reader(name)(run)


def test_ssd_readers_against_hand_worked_numbers():
    tr = trace_lib.Trace(2, 7.0, [("gemm", 0.0, 1.0)], [], dict(OPS))
    assert _read("ssm_mixer_ms.train", tr) == pytest.approx(1e3 * 0.55 / 2)
    assert _read("ssm_scan_ms.train", tr) == pytest.approx(1e3 * 0.16 / 2)
    call = (128, 128, 64, 64, 128)
    fwd = costs_ssd.ssd_intra_chunk_cost(*call).bound_s()
    bwd = costs_ssd.ssd_intra_chunk_bwd(*call).bound_s()
    assert _read("ssd_intra_roofline.train", tr) == pytest.approx(
        100 * 72 * fwd / 0.034)
    assert _read("ssd_bwd_roofline.train", tr) == pytest.approx(
        100 * 36 * bwd / 0.63)
    # the shares of the traced magnitudes lie under 100%
    assert 0 < _read("ssd_intra_roofline.train", tr) < 100
    assert 0 < _read("ssd_bwd_roofline.train", tr) < 100


@pytest.mark.parametrize("missing", sorted(OPS))
def test_a_reader_whose_span_or_op_is_missing_reads_nothing(missing):
    """The parent's trace has no ``ssm.`` span: those readers read None
    and raise nothing, and the others read on."""
    ops = {k: v for k, v in OPS.items() if k != missing}
    tr = trace_lib.Trace(1, 4.0, [], [], ops)
    reads = {name: _read(name, tr) for name in SSD_METRICS}
    silent = {"ssm.mixer": "ssm_mixer_ms.train",
              "ssm.scan": "ssm_scan_ms.train",
              "repro_torch::ssd_intra_chunk": "ssd_intra_roofline.train",
              "_SsdIntraChunkBackward": "ssd_bwd_roofline.train"}[missing]
    assert {k for k, v in reads.items() if v is None} == {silent}


def test_every_metric_of_the_new_cells_reads_nothing_from_nothing():
    for cell in (CELL, "olmo1b-train-seq1k"):
        c = harness.load_cell(cell)
        empty = harness.Run(c, [], trace_lib.Trace(1, 1.0, [], [], {}))
        for m in c.per_layer:
            assert harness.metric_reader(m["name"])(empty) is None
            assert harness.metric_reader(m["name"])(
                harness.Run(c, [], None)) is None


def test_step_mfu_reads_the_family_modules_flops():
    from bench.reference import granite_hybrid

    c = harness.load_cell(CELL)
    flops = granite_hybrid.step_flops(c.config["model"], 4096, 4)
    assert flops == 322_484_129_759_232
    run = harness.Run(c, [3.0, 4.0], None, 7.0)
    assert harness.metric_reader("step_mfu.train")(run) == pytest.approx(
        100 * flops / 3.5 / costs.PEAK_BF16_FLOPS)
