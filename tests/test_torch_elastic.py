"""The port's elastic runtime against the JAX package's, on the CPU at the
olmo smoke size in f32: the same 5-step loss trajectory at splice 1, 2 and
4 from a state bridged from JAX (and at bf16, splice 1, to a looser
bound), and the runtime's own invariants
(``tests/test_elastic.py``): resizes leave the trajectory as it was,
snapshots resume bit for bit, the ZeRO placement rule and the preemption
barrier hold.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.elastic import ElasticRuntime as JaxElasticRuntime
from repro_torch.bridge import train_state_from_jax
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.elastic import ElasticRuntime


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
TCFG = dict(total_steps=40, warmup_steps=2, learning_rate=1e-3)
W, G, S = 4, 8, 32
STEPS = 5
# f32 on both sides; the two frameworks sum in other orders, and AdamW's
# first steps move entries with near-zero gradients by amounts that rest
# on their last bits: 1e-5 relative on the loss after 5 steps
LOSS_RTOL = 1e-5
# bf16: activations round at other places in the two frameworks; each
# row's loss moved by about 1e-4 relative in this test's first run, so
# test_elastic.py's bound of 1e-3 relative
BF16_LOSS_RTOL = 1e-3


def _jax_cfg(dtype="float32"):
    return dataclasses.replace(jax_smoke_config("olmo-1b"), dtype=dtype)


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX runtime's state after construction (as numpy), its f32 loss
    trajectories at splice 1, 2 and 4 and its bf16 one at splice 1."""
    jtcfg = JaxTrainConfig(**TCFG)
    runs = {}
    for physical in (4, 2, 1):
        rt = JaxElasticRuntime(_jax_cfg(), jtcfg, W, physical, G, S)
        runs[W // physical] = [r["loss"] for r in rt.run_steps(STEPS)]
    rt = JaxElasticRuntime(_jax_cfg("bfloat16"), jtcfg, W, W, G, S)
    runs["bfloat16"] = [r["loss"] for r in rt.run_steps(STEPS)]
    state = JaxElasticRuntime(_jax_cfg(), jtcfg, W, W, G, S).state
    return jax.tree_util.tree_map(np.asarray, state), runs


def _runtime(state_np, physical, cfg=CFG):
    state = train_state_from_jax(state_np, cfg, device="cpu")
    return ElasticRuntime(cfg, TrainConfig(**TCFG), W, physical, G, S,
                          state=state, device="cpu")


@pytest.mark.parametrize("splice", [1, 2, 4])
def test_trajectory_matches_jax(jax_runs, splice):
    state_np, runs = jax_runs
    rt = _runtime(state_np, W // splice)
    assert rt.splice == splice
    hist = rt.run_steps(STEPS)
    assert [h["step"] for h in hist] == list(range(1, STEPS + 1))
    assert all(h["splice"] == splice and np.isfinite(h["grad_norm"])
               for h in hist)
    np.testing.assert_allclose([h["loss"] for h in hist], runs[splice],
                               rtol=LOSS_RTOL)


def test_bf16_trajectory_matches_jax(jax_runs):
    state_np, runs = jax_runs
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    hist = _runtime(state_np, W, cfg).run_steps(STEPS)
    np.testing.assert_allclose([h["loss"] for h in hist], runs["bfloat16"],
                               rtol=BF16_LOSS_RTOL)


def test_trajectory_invariant_under_resize(jax_runs):
    """Resizes mid-run leave the trajectory as it was (test_elastic.py's
    bound, 1e-3 relative), and as JAX's at splice 1."""
    state_np, runs = jax_runs
    full = _runtime(state_np, W).run_steps(7)
    elastic = _runtime(state_np, W)
    elastic.run_steps(2)
    ev = elastic.resize(1)           # 4 devices -> 1 (4-way splice)
    assert ev == {"from": 4, "to": 1, "splice": 4, "at_step": 2,
                  "resize_seconds": ev["resize_seconds"]}
    elastic.run_steps(3)
    elastic.resize(2)
    elastic.run_steps(2)
    assert [h["splice"] for h in elastic.history] == [1, 1, 4, 4, 4, 2, 2]
    for a, b in zip(full, elastic.history):
        assert abs(a["loss"] - b["loss"]) / a["loss"] < 1e-3, (a, b)
    np.testing.assert_allclose([h["loss"] for h in full[:STEPS]], runs[1],
                               rtol=LOSS_RTOL)


def test_init_state_from_the_train_seed():
    """Without a state the runtime draws one from ``tcfg.seed``: two
    runtimes of one seed agree, another seed differs."""
    a = ElasticRuntime(CFG, TrainConfig(**TCFG), W, W, G, S, device="cpu")
    b = ElasticRuntime(CFG, TrainConfig(**TCFG), W, 2, G, S, device="cpu")
    c = ElasticRuntime(CFG, TrainConfig(**TCFG, seed=1), W, W, G, S,
                       device="cpu")
    ea, eb, ec = (rt.state["params"]["embed"] for rt in (a, b, c))
    assert torch.equal(ea, eb) and not torch.equal(ea, ec)
    assert a.state["params"]["embed"].dtype == torch.float32
    assert int(a.state["step"]) == 0


def test_snapshot_resume_bit_exact():
    rt = ElasticRuntime(CFG, TrainConfig(**TCFG), W, 2, G, S, device="cpu")
    rt.run_steps(3)
    snap = rt.snapshot()
    assert snap["pipeline"] == {"seed": 0, "step": 3}
    assert isinstance(snap["state"]["params"]["embed"], np.ndarray)
    resumed = ElasticRuntime.from_snapshot(CFG, TrainConfig(**TCFG), snap, 2,
                                           G, S, device="cpu")
    a = rt.run_steps(2)
    b = resumed.run_steps(2)
    for x, y in zip(a, b):
        assert x["loss"] == y["loss"]        # bit exact
        assert x["step"] == y["step"]


def test_invalid_resize_rejected():
    rt = ElasticRuntime(CFG, TrainConfig(**TCFG), W, W, G, S, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        rt.resize(3)                         # 4 % 3 != 0
    with pytest.raises(ValueError, match="not divisible"):
        ElasticRuntime(CFG, TrainConfig(**TCFG), W, 3, G, S, device="cpu")
    assert rt.physical == W


def test_zero_partial_sharding_blocks_oversplice():
    tcfg = dataclasses.replace(TrainConfig(**TCFG), zero_shard_factor=2)
    rt = ElasticRuntime(CFG, tcfg, 4, 4, G, S, device="cpu")
    rt.resize(2)                             # splice 2 == max allowed
    with pytest.raises(ValueError, match="partial sharding"):
        rt.resize(1)                         # splice 4 > 4/2


def test_preemption_barrier_rides_the_step():
    """A preemption request is acked by the next step and acquired (the
    job is quiesced) at the step after; run_steps stops there."""
    rt = ElasticRuntime(CFG, TrainConfig(**TCFG), W, W, G, S, device="cpu")
    rt.run_steps(1)
    assert not rt.quiesced
    rt.request_preemption()
    recs = rt.run_steps(5, stop_on_barrier=True)
    assert [r["barrier_acquired"] for r in recs] == [False, True]
    assert rt.quiesced and int(rt.state["step"]) == 3
    rt.barrier.reset()
    assert not rt.quiesced


def test_step_builds_once_per_splice():
    rt = ElasticRuntime(CFG, TrainConfig(**TCFG), W, W, G, S, device="cpu")
    rt.run_steps(1)
    rt.resize(2)
    rt.resize(4)
    rt.resize(2)
    assert sorted(rt._steps) == [1, 2]
