"""The port's preemption, checkpoint and migration flow
(``repro_torch.core.migration``) on the CPU at the olmo smoke size in f32:
ports of ``tests/test_preemption_flow.py``, of the checkpoint and
migration tests of ``tests/test_elastic.py`` and of
``tests/test_system.py::test_full_lifecycle``; a job checkpointed by the
JAX package and resumed by the port on JAX's loss trajectory; the port's
``MigrationReport`` priced by the JAX scheduler's ``CostModel``; and the
``--ckpt-every`` command.
"""
import dataclasses
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.checkpoint import CheckpointStore as JaxCheckpointStore
from repro.core.elastic import ElasticRuntime as JaxElasticRuntime
from repro.core.migration import checkpoint_job as jax_checkpoint_job
from repro.core.migration import migrate as jax_migrate
from repro.scheduler.costs import CostModel, RegionTopology
from repro_torch.bridge import train_state_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core import (CheckpointStore, ElasticRuntime, MigrationReport,
                              checkpoint_job, migrate, run_barrier_simulation)
from repro_torch.launch import train as train_cli
from repro_torch.training.state import init_train_state


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
TCFG = TrainConfig(total_steps=40, warmup_steps=2, learning_rate=1e-3)
W, G, S = 4, 8, 32
# test_torch_elastic.py's bound of the port's loss against JAX's, f32
LOSS_RTOL = 1e-5


def _rt(physical, **kw):
    return ElasticRuntime(CFG, TCFG, W, physical, G, S, device="cpu", **kw)


# ------------------------------------------- tests/test_preemption_flow.py
def test_preemption_via_in_graph_barrier():
    rt = _rt(4)
    recs = rt.run_steps(2)
    assert not any(r["barrier_acquired"] for r in recs)   # phase 1 is free

    rt.request_preemption()
    recs = rt.run_steps(4, stop_on_barrier=True)
    # the paper's bound: quiesced within two mini-batches of the command
    assert len(recs) <= 2
    assert recs[-1]["barrier_acquired"] and rt.quiesced

    # checkpoint at the quiesced boundary, release, resume
    store = CheckpointStore()
    stats = checkpoint_job(rt, store, "preempt-job")
    assert stats.device_stored_bytes > 0
    step_at_ckpt = int(rt.state["step"])
    rt.barrier.reset()
    more = rt.run_steps(2)
    assert int(rt.state["step"]) == step_at_ckpt + 2
    assert not any(r["barrier_acquired"] for r in more)

    # restore elsewhere: exactly the checkpointed step
    device, host, step = store.restore("preempt-job")
    assert step == step_at_ckpt
    resumed = ElasticRuntime.from_snapshot(
        CFG, TCFG,
        {"state": device[0], "pipeline": host[0]["pipeline"],
         "world_size": host[0]["world_size"]}, 2, G, S, device="cpu")
    assert int(resumed.state["step"]) == step_at_ckpt
    loss = resumed.run_steps(1)[0]["loss"]
    assert np.isfinite(loss)


# ------------------------------------------------ tests/test_elastic.py:56-98
def test_snapshot_resume_bit_exact():
    """Through the store: snapshot, restore, resume; bit-exact losses."""
    rt = _rt(2)
    rt.run_steps(3)
    store = CheckpointStore()
    checkpoint_job(rt, store, "job")
    device, host, _ = store.restore("job")
    resumed = ElasticRuntime.from_snapshot(
        CFG, TCFG, {"state": device[3], "pipeline": host[3]["pipeline"],
                    "world_size": host[3]["world_size"]}, 2, G, S,
        device="cpu")
    assert list(resumed.state) == list(rt.state)
    a = rt.run_steps(2)
    b = resumed.run_steps(2)
    for x, y in zip(a, b):
        assert x["loss"] == y["loss"]        # BIT exact


def test_migration_work_conserving():
    rt = _rt(4)
    rt.run_steps(2)
    store = CheckpointStore()
    # same physical count -> BIT-exact resume
    same_rt, report = migrate(rt, store, "mig-same", 4, CFG, TCFG, G, S,
                              device="cpu")
    assert isinstance(report, MigrationReport)
    assert report.work_conserving
    assert report.barrier_minibatches <= 2
    assert report.from_physical == 4 and report.to_physical == 4
    l_old = rt.run_steps(1)[0]["loss"]
    assert same_rt.run_steps(1)[0]["loss"] == l_old
    # migrate + scale-down: work-conserving, trajectory equal to float
    # accumulation-order tolerance (splice changes the reduction order)
    rt2 = _rt(4)
    rt2.run_steps(2)
    store2 = CheckpointStore()
    new_rt, report2 = migrate(rt2, store2, "mig-down", 2, CFG, TCFG, G, S,
                              device="cpu")
    assert report2.work_conserving and new_rt.splice == 2
    l_new = new_rt.run_steps(1)[0]["loss"]
    assert abs(l_new - l_old) / l_old < 1e-4


def test_checkpoint_size_independent_of_world_size():
    sizes = {}
    for w in (2, 4):
        rt = ElasticRuntime(CFG, TCFG, w, w, G, S, device="cpu")
        rt.run_steps(1)
        store = CheckpointStore()
        stats = checkpoint_job(rt, store, "job")
        sizes[w] = stats.device_stored_bytes
        assert stats.n_workers == w
    assert sizes[2] == sizes[4]              # Table 4: S_G dedup across DP


# --------------------------------- tests/test_system.py::test_full_lifecycle
def test_full_lifecycle():
    # reference: undisturbed run
    ref = _rt(W)
    ref_hist = ref.run_steps(10)

    # the managed job: shrink -> checkpoint/migrate -> grow
    rt = _rt(W)
    rt.run_steps(3)
    rt.resize(1)                                 # capacity crunch: 4 -> 1
    rt.run_steps(2)

    bres = run_barrier_simulation(W, 3, command_at_step=5, schedule_seed=0)
    assert bres.acquired and bres.consistent_cut  # quiesce before dump

    store = CheckpointStore()
    rt2, report = migrate(rt, store, "lifecycle", 2, CFG, TCFG, G, S,
                          device="cpu")
    assert report.work_conserving
    rt2.run_steps(3)
    rt2.resize(4)                                # capacity back: grow
    rt2.run_steps(2)

    hist = rt.history + rt2.history
    assert len(hist) == 10
    for a, b in zip(ref_hist, hist):
        assert abs(a["loss"] - b["loss"]) / a["loss"] < 2e-3, (a, b)


# ------------------------------------------------------ against the JAX one
@pytest.fixture(scope="module")
def jax_job(tmp_path_factory):
    """A JAX job at splice 1 after 2 steps: checkpointed to disk by the JAX
    package, migrated by it to 2 devices across a region pair, then run 3
    more steps.  Returns the store's root, the JAX state and pipeline at
    step 2, its migration report and its losses of steps 3-5."""
    cfg = dataclasses.replace(jax_smoke_config("olmo-1b"), dtype="float32")
    tcfg = JaxTrainConfig(total_steps=40, warmup_steps=2, learning_rate=1e-3)
    rt = JaxElasticRuntime(cfg, tcfg, W, W, G, S)
    rt.run_steps(2)
    root = tmp_path_factory.mktemp("jax-store")
    jax_checkpoint_job(rt, JaxCheckpointStore(root=str(root)), "jax-job")
    snap = rt.snapshot()
    _, report = jax_migrate(rt, JaxCheckpointStore(), "mig", 2, cfg, tcfg, G,
                            S, topology=RegionTopology.tiered(
                                ["r0", "r1", "r2"]),
                            src_region="r0", dst_region="r2")
    losses = [r["loss"] for r in rt.run_steps(3)]
    return root, snap, report, losses


def test_jax_checkpoint_resumes_on_jax_trajectory(jax_job):
    """The port restores a store the JAX package wrote (with its own state
    as the template) and continues on JAX's loss trajectory."""
    root, _, _, losses = jax_job
    store = CheckpointStore(root=str(root))
    like = init_train_state(CFG, TCFG, device="cpu")
    device, host, step = store.restore("jax-job", like=like)
    assert step == 2 and host[0]["pipeline"] == {"seed": 0, "step": 2}
    rt = ElasticRuntime.from_snapshot(
        CFG, TCFG, {"state": device[0], "pipeline": host[0]["pipeline"],
                    "world_size": host[0]["world_size"]}, W, G, S,
        device="cpu")
    assert int(rt.state["step"]) == 2 and list(rt.state) == list(like)
    hist = rt.run_steps(3)
    assert [h["step"] for h in hist] == [3, 4, 5]
    np.testing.assert_allclose([h["loss"] for h in hist], losses,
                               rtol=LOSS_RTOL)


def test_report_prices_like_jax_in_the_cost_model(jax_job):
    """The port's report of the same state over the same region pair of
    JAX's RegionTopology: equal stored bytes and modelled transfer seconds;
    the scheduler's CostModel takes it as it takes JAX's."""
    _, snap, want, _ = jax_job
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        snap["state"]), CFG)
    rt = _rt(W, state=state, pipeline_state=snap["pipeline"])
    topo = RegionTopology.tiered(["r0", "r1", "r2"])
    new_rt, got = migrate(rt, CheckpointStore(), "mig", 2, CFG, TCFG, G, S,
                          topology=topo, src_region="r0", dst_region="r2",
                          device="cpu")
    assert got.work_conserving and int(new_rt.state["step"]) == 2
    for field in ("device_stored_bytes", "host_stored_bytes",
                  "upload_seconds", "download_seconds", "barrier_seconds",
                  "barrier_minibatches", "from_physical", "to_physical",
                  "src_region", "dst_region"):
        assert getattr(got, field) == getattr(want, field), field
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.transfer_seconds() == want.transfer_seconds()
    cm = CostModel.from_reports([got])
    cm_jax = CostModel.from_reports([want])
    assert cm.blob_bandwidth == cm_jax.blob_bandwidth
    assert cm.topology.bandwidth("r0", "r2") == \
        cm_jax.topology.bandwidth("r0", "r2")


def test_migrate_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is valid")
    rt = _rt(W)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        migrate(rt, CheckpointStore(), "job", 2, CFG, TCFG, G, S)


# ---------------------------------------------------------------- the CLI
def test_train_command_checkpoints_on_cpu(capsys):
    train_cli.main(["--device", "cpu", "--steps", "5", "--ckpt-every", "2"])
    lines = [line for line in capsys.readouterr().out.splitlines()
             if line.startswith("[ckpt]")]
    assert [line.split()[1] for line in lines] == ["step=2", "step=4"]
    pattern = (r"\[ckpt\] step=\d+ stored=(\d+\.\d)MB \(logical "
               r"(\d+\.\d)MB, 4 workers\)")
    for line in lines:
        stored, logical = map(float, re.fullmatch(pattern, line).groups())
        assert 0 < stored <= logical / 4
