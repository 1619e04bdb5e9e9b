"""The port's content-deduplicated checkpoint store
(``repro_torch.core.checkpoint``) on the CPU: the six tests of
``tests/test_checkpoint.py`` on the port's store; the same manifest as the
JAX package's for one bridged olmo smoke train state (chunk keys, each
worker's device refs in order, host blobs, stats); and a store that the
JAX package wrote to disk, restored by the port with a template.
"""
import dataclasses
import pickle

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.checkpoint import CheckpointStore as JaxCheckpointStore
from repro.core.elastic import ElasticRuntime as JaxElasticRuntime
from repro.core.migration import checkpoint_job as jax_checkpoint_job
from repro_torch.bridge import train_state_from_jax, train_state_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.checkpoint import CheckpointStore
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.core.migration import checkpoint_job
from repro_torch.training.state import init_train_state
from repro_torch.utils.tree import (tree_flatten, tree_from_spec, tree_spec,
                                    tree_unflatten_sorted)


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


def _state(seed, scale=1.0):
    rng = np.random.Generator(np.random.Philox(seed))
    return {"p": (scale * rng.standard_normal((64, 64))).astype(np.float32),
            "o": {"m": rng.standard_normal(128).astype(np.float32)}}


# ------------------------------------------- tests/test_checkpoint.py, ported
def test_cross_worker_dedup_sg_independent_of_dp_degree():
    """DP replicas hold identical device state: stored bytes must not grow
    with the worker count (Table 4's S_G property)."""
    shared = _state(1)
    sizes = {}
    for workers in (2, 8):
        store = CheckpointStore()
        stats = store.snapshot(
            "job", 0,
            {w: shared for w in range(workers)},
            {w: {"rank": w, "step": 0} for w in range(workers)})
        sizes[workers] = stats.device_stored_bytes
        assert stats.device_logical_bytes == workers * sizes[workers]
    assert sizes[2] == sizes[8]


def test_temporal_dedup_incremental_smaller():
    """Subsequent snapshots store only changed chunks (§4.6)."""
    store = CheckpointStore()
    s0 = _state(2)
    first = store.snapshot("job", 0, {0: s0}, {0: {"step": 0}})
    s1 = {"p": s0["p"] + 0.1, "o": s0["o"]}
    second = store.snapshot("job", 1, {0: s1}, {0: {"step": 1}})
    assert 0 < second.device_stored_bytes < first.device_stored_bytes


def test_restore_roundtrip_bit_exact():
    store = CheckpointStore()
    state = _state(3)
    store.snapshot("job", 5, {0: state, 1: state}, {0: {"x": 1}, 1: {"x": 2}})
    device, host, step = store.restore("job")
    assert step == 5
    np.testing.assert_array_equal(device[0]["p"], state["p"])
    np.testing.assert_array_equal(device[1]["o"]["m"], state["o"]["m"])
    assert host[0] == {"x": 1} and host[1] == {"x": 2}


def test_restore_specific_step():
    store = CheckpointStore()
    store.snapshot("job", 1, {0: _state(1)}, {0: {}})
    store.snapshot("job", 2, {0: _state(2)}, {0: {}})
    device, _, step = store.restore("job", step=1)
    assert step == 1
    np.testing.assert_array_equal(device[0]["p"], _state(1)["p"])


def test_disk_backed_store(tmp_path):
    store = CheckpointStore(root=str(tmp_path))
    state = _state(4)
    store.snapshot("job", 0, {0: state}, {0: {"step": 0}})
    # a fresh store over the same root reads chunks and manifests back
    fresh = CheckpointStore(root=str(tmp_path))
    device, host, _ = fresh.restore("job")
    np.testing.assert_array_equal(device[0]["p"], state["p"])
    assert host[0] == {"step": 0}


def test_file_tracking_dedup():
    store = CheckpointStore()
    files = {0: {"/w/a.txt": b"hello" * 100},
             1: {"/w/a.txt": b"hello" * 100}}   # identical content
    stats = store.snapshot("job", 0, {0: _state(5), 1: _state(5)},
                           {0: {}, 1: {}}, files_by_worker=files)
    # file content stored once despite two workers writing it
    assert stats.host_stored_bytes < 2 * len(b"hello" * 100) + 1000
    refs = [store.manifests["job"][0]["workers"][w]["files"]["/w/a.txt"]
            for w in ("0", "1")]
    assert refs[0] == refs[1]


# ------------------------------------------------------- against the JAX one
@pytest.fixture(scope="module")
def jax_state():
    """A JAX olmo smoke runtime after construction; its state as numpy."""
    rt = JaxElasticRuntime(dataclasses.replace(
        jax_smoke_config("olmo-1b"), dtype="float32"),
        JaxTrainConfig(**TCFG), W, W, G, S)
    return rt, jax.tree_util.tree_map(np.asarray, rt.state)


def test_tree_flatten_matches_jax_order(jax_state):
    """The manifest's leaf order is ``jax.tree_util``'s: sorted keys, None
    dropped; the port's own tree walks another order."""
    _, state_np = jax_state
    ours = train_state_to_numpy(train_state_from_jax(state_np, CFG))
    leaves, paths = tree_flatten(ours)
    own = init_train_state(CFG, TrainConfig(**TCFG), device="cpu")
    assert list(own) == ["params", "opt", "step"]
    assert tree_flatten(own)[1] == paths
    want = jax.tree_util.tree_flatten_with_path(state_np)[0]
    assert paths == [tuple(k.key for k in path) for path, _ in want]
    assert paths[:3] == [("opt", "count"),
                         ("opt", "m", "blocks", "attn", "wk"),
                         ("opt", "m", "blocks", "attn", "wo")]
    assert len(leaves) == 26 and paths[-1] == ("step",)
    for got, (_, leaf) in zip(leaves, want):
        np.testing.assert_array_equal(got, leaf)
    back = tree_unflatten_sorted(own, leaves)
    assert list(back) == ["params", "opt", "step"]
    assert list(back["params"]["blocks"]) == list(own["params"]["blocks"])
    np.testing.assert_array_equal(back["params"]["embed"],
                                  state_np["params"]["embed"])
    spec = tree_spec(own)
    skeleton = tree_from_spec(spec)
    assert tree_spec(skeleton) == spec
    assert skeleton["params"]["blocks"]["ln1"] is None


def test_snapshot_matches_jax_store(jax_state):
    """One bridged state, checkpointed by each package's checkpoint_job
    over W workers: the same chunk keys, the same device refs per worker in
    the same order, equal host blobs, equal stats but wall time."""
    jrt, state_np = jax_state
    rt = ElasticRuntime(CFG, TrainConfig(**TCFG), W, W, G, S,
                        state=train_state_from_jax(state_np, CFG),
                        device="cpu")
    jstore, store = JaxCheckpointStore(), CheckpointStore()
    want = jax_checkpoint_job(jrt, jstore, "job")
    got = checkpoint_job(rt, store, "job")
    assert set(store.chunks) == set(jstore.chunks)
    jm, m = jstore.manifests["job"][0], store.manifests["job"][0]
    assert set(m["workers"]) == set(jm["workers"]) == {"0", "1", "2", "3"}
    for w in jm["workers"]:
        assert m["workers"][w]["device"] == jm["workers"][w]["device"]
        assert len(m["workers"][w]["device"]) == 26
        assert m["workers"][w]["host"] == jm["workers"][w]["host"]
        assert pickle.loads(store._get_blob(m["workers"][w]["host"])) == \
            {"pipeline": {"seed": 0, "step": 0}, "world_size": W,
             "rank": int(w)}
    assert dataclasses.asdict(got) == dict(dataclasses.asdict(want),
                                           wall_seconds=got.wall_seconds)
    # the workers' replicas dedup (Table 4), and the zero moments of a new
    # state dedup within one worker too
    assert got.device_stored_bytes * W < got.device_logical_bytes


def test_jax_written_store_restores_with_a_template(jax_state, tmp_path):
    """A store the JAX package wrote to disk restores in the port: with a
    template tree of the state's structure, each worker's state equals
    JAX's; without one it raises, and no treedef is unpickled."""
    jrt, state_np = jax_state
    jax_checkpoint_job(jrt, JaxCheckpointStore(root=str(tmp_path)), "job")
    store = CheckpointStore(root=str(tmp_path))
    with pytest.raises(ValueError, match="like="):
        store.restore("job")
    # the port's own state: its structure, in its own key order
    template = init_train_state(CFG, TrainConfig(**TCFG), device="cpu")
    device, host, step = store.restore("job", like=template)
    assert step == 0 and sorted(device) == list(range(W))
    assert host[2] == {"pipeline": {"seed": 0, "step": 0}, "world_size": W,
                       "rank": 2}
    got = device[1]
    assert list(got) == ["params", "opt", "step"]
    assert got["params"]["blocks"]["ln1"] is None
    want_leaves, want_paths = tree_flatten(state_np)
    got_leaves, got_paths = tree_flatten(got)
    assert got_paths == want_paths
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # a template of another shape is refused, not silently refilled
    wrong = dict(template, step=torch.zeros(3))
    with pytest.raises(ValueError, match="template"):
        store.restore("job", like=wrong)
