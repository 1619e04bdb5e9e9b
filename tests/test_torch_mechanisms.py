"""The port's copies of the numpy mechanism models of ``repro.core`` (the
bidirectional allocator, the device proxy, the splicing engine and squash
validation) hold the assertions of ``tests/test_buffers.py``,
``tests/test_device_proxy.py`` and ``tests/test_splicing.py``.

Each of those tests is here once, parametrised over the two packages
(``repro`` and ``repro_torch``), with the same body for both; and seeded
``SplicedTrainer`` runs give the same ``SpliceMetrics``, stable addresses
and parameters from both, bit for bit.  No JAX is needed: the modules are
numpy (``tests/test_torch_copies.py`` holds them equal by AST).
"""
import dataclasses
import importlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

PACKAGES = ["repro", "repro_torch"]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


# ---------------------------------------------------------------------------
# tests/test_buffers.py: the bidirectional allocator (§5.2.2)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
@settings(max_examples=40, deadline=None)
@given(stable_sizes=st.lists(st.integers(1, 64).map(lambda x: x * 16),
                             min_size=1, max_size=8),
       transient_a=st.lists(st.integers(1, 32).map(lambda x: x * 8),
                            min_size=0, max_size=8),
       transient_b=st.lists(st.integers(1, 32).map(lambda x: x * 8),
                            min_size=0, max_size=8),
       seed=st.integers(0, 1000))
def test_stable_addresses_invariant_to_transient_interleaving(
        pkg, stable_sizes, transient_a, transient_b, seed):
    """Two replicas with the same stable allocations and different
    transient ones place the stable buffers at the same addresses."""
    DeviceMemory = _mod(pkg, "core.buffers").DeviceMemory
    rng = np.random.Generator(np.random.Philox(seed))

    def run(transients):
        mem = DeviceMemory(1 << 20)
        stable_addrs = []
        t_queue = list(transients)
        live_transients = []
        for size in stable_sizes:
            while t_queue and rng.random() < 0.6:
                b = mem.alloc(t_queue.pop(), stable=False)
                live_transients.append(b.addr)
            if live_transients and rng.random() < 0.5:
                mem.free(live_transients.pop())
            stable_addrs.append(mem.alloc(size, stable=True).addr)
        return stable_addrs

    assert run(transient_a) == run(transient_b)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_regions_never_collide(pkg):
    buffers = _mod(pkg, "core.buffers")
    mem = buffers.DeviceMemory(1024)
    s = mem.alloc(256, stable=True)
    t = mem.alloc(256, stable=False)
    assert t.addr + t.size <= s.addr
    with pytest.raises(buffers.OutOfMemory):
        mem.alloc(1024, stable=False)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_lazy_free_content_cached(pkg):
    mem = _mod(pkg, "core.buffers").DeviceMemory(1024)
    b = mem.alloc(64, stable=True)
    mem.write(b.addr, np.arange(16, dtype=np.float32))
    cs = b.checksum()
    mem.free(b.addr, lazy=True)
    assert mem.find_by_checksum(cs) is not None   # cached (§5.2.1)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_transient_reclaim(pkg):
    mem = _mod(pkg, "core.buffers").DeviceMemory(1024)
    a = mem.alloc(512, stable=False)
    mem.free(a.addr)
    b = mem.alloc(1024 - 16, stable=False)   # fits again after reclaim
    assert b.addr == 0


# ---------------------------------------------------------------------------
# tests/test_device_proxy.py: interception, virtual handles, log/replay
# ---------------------------------------------------------------------------

def _session(proxy):
    server = proxy.DeviceProxyServer(1 << 20)
    client = proxy.DeviceProxyClient(server)
    stream = client.call("create_stream")
    event = client.call("create_event")
    comm = client.call("create_communicator", 4, 0)
    buf = client.call("malloc", 1024, True)
    client.call("memcpy_h2d", buf, np.arange(256, dtype=np.float32))
    return server, client, stream, event, comm, buf


@pytest.mark.parametrize("pkg", PACKAGES)
def test_virtual_handles_stable_across_restore(pkg):
    proxy = _mod(pkg, "core.device_proxy")
    _, client, *_, buf = _session(proxy)
    state = client.snapshot_device_state()
    old_phys = dict(client.v2p)
    fresh = proxy.DeviceProxyServer(1 << 20, device_id=1)
    client.restore(fresh, state)
    assert set(client.v2p) == set(old_phys)
    np.testing.assert_array_equal(client.call("memcpy_d2h", buf),
                                  np.arange(256, dtype=np.float32))
    assert len(fresh.streams) == 1
    assert len(fresh.communicators) == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_stable_buffers_same_address_after_restore(pkg):
    proxy = _mod(pkg, "core.device_proxy")
    _, client, *_, buf = _session(proxy)
    addr_before = client.v2p[buf]
    state = client.snapshot_device_state()
    client.restore(proxy.DeviceProxyServer(1 << 20), state)
    assert client.v2p[buf] == addr_before


@pytest.mark.parametrize("pkg", PACKAGES)
def test_log_compaction_drops_freed_mallocs(pkg):
    proxy = _mod(pkg, "core.device_proxy")
    client = proxy.DeviceProxyClient(proxy.DeviceProxyServer(1 << 20))
    keep = client.call("malloc", 64, True)
    drop = client.call("malloc", 64, False)
    client.call("free", drop)
    mallocs = [e for e in client.compact_log() if e.api == "malloc"]
    assert len(mallocs) == 1 and mallocs[0].virtual_handle == keep


@pytest.mark.parametrize("pkg", PACKAGES)
def test_kernel_launch_executes_on_server_memory(pkg):
    proxy = _mod(pkg, "core.device_proxy")
    server = proxy.DeviceProxyServer(1 << 20)
    client = proxy.DeviceProxyClient(server)
    a = client.call("malloc", 64, False)
    o = client.call("malloc", 64, False)
    client.call("memcpy_h2d", a, np.full(16, 2.0, np.float32))
    client.call("launch_kernel", lambda x: x * 3.0,
                (client.v2p[a],), (client.v2p[o],))
    np.testing.assert_allclose(client.call("memcpy_d2h", o), 6.0)
    assert server.kernel_launches == 1


@pytest.mark.parametrize("pkg", PACKAGES)
def test_file_io_tracking(pkg):
    proxy = _mod(pkg, "core.device_proxy")
    client = proxy.DeviceProxyClient(proxy.DeviceProxyServer(1 << 10))
    client.open_file("/tmp/x", "r")
    client.open_file("/tmp/y", "w")
    client.open_file("/tmp/z", "a+")
    assert client.written_files == ["/tmp/y", "/tmp/z"]


# ---------------------------------------------------------------------------
# tests/test_splicing.py: dedup, squashing, conservative validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PACKAGES)
def test_stable_addresses_consistent_across_ranks(pkg):
    t = _mod(pkg, "core.splicing").SplicedTrainer(n_ranks=4, seed=1)
    ref = t.stable_addresses(0)
    for r in range(1, 4):
        assert t.stable_addresses(r) == ref


@pytest.mark.parametrize("pkg", PACKAGES)
def test_squashing_preserves_trajectory(pkg):
    SplicedTrainer = _mod(pkg, "core.splicing").SplicedTrainer
    a = SplicedTrainer(n_ranks=3, seed=5, squash=True)
    b = SplicedTrainer(n_ranks=3, seed=5, squash=False)
    for _ in range(10):
        a.run_minibatch()
        b.run_minibatch()
    np.testing.assert_allclose(a.params(0), b.params(0), rtol=1e-6)
    for r in range(3):
        np.testing.assert_allclose(a.params(r), a.params(0))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_squashing_elides_work(pkg):
    SplicedTrainer = _mod(pkg, "core.splicing").SplicedTrainer
    a = SplicedTrainer(n_ranks=4, seed=2, squash=True)
    b = SplicedTrainer(n_ranks=4, seed=2, squash=False)
    for _ in range(8):
        a.run_minibatch()
        b.run_minibatch()
    ma, mb = a.device.metrics, b.device.metrics
    assert ma.squashed_ops == 8 * 3
    assert ma.executed_update_ops < mb.executed_update_ops
    assert ma.swapin_bytes < mb.swapin_bytes
    assert ma.allreduces_issued == 8


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conservative_validation_accepts_conforming_model(pkg):
    t = _mod(pkg, "core.splicing").SplicedTrainer(n_ranks=3, seed=3)
    out = _mod(pkg, "core.validation").run_validated_training(
        t, 9, validate_every=3)
    assert out["squash_disabled"] is None
    assert all(r.ok for r in out["reports"])


def _bad_update(p, o, g, rank):
    """A rank-dependent update: it breaks the mutation-identity
    invariant that squashing rests on."""
    return p - 0.05 * (0.9 * o + g) - 1e-3 * rank, 0.9 * o + g


@pytest.mark.parametrize("pkg", PACKAGES)
def test_conservative_validation_catches_pathological_model(pkg):
    t = _mod(pkg, "core.splicing").SplicedTrainer(n_ranks=3, seed=4,
                                                  update_fn=_bad_update)
    out = _mod(pkg, "core.validation").run_validated_training(
        t, 6, validate_every=2)
    assert out["squash_disabled"] is not None
    assert t.params(0).shape == (64,)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_validation_report_structure(pkg):
    validate = _mod(pkg, "core.validation").validate_squashing_window
    rep = validate({0: {"P": (1, "x")}, 1: {"P": (1, "x")}})
    assert rep.ok and rep.n_ranks_checked == 2
    assert not validate({0: {"P": (1, "x")}, 1: {"P": (2, "x")}}).ok


@pytest.mark.parametrize("pkg", PACKAGES)
@settings(max_examples=20, deadline=None)
@given(dp=st.sampled_from([2, 4, 8, 16]), shard=st.sampled_from([1, 2, 4]))
def test_zero_partial_sharding_rules(pkg, dp, shard):
    """§5.4: DP = k x shard supports at most k-way splicing; groups hold
    ranks with identical shards only."""
    zero = _mod(pkg, "optim.zero")
    if dp % shard:
        return
    k = zero.max_splice_factor(dp, shard)
    assert k == dp // shard
    zero.validate_partial_sharding(dp, shard, k)
    with pytest.raises(ValueError):
        zero.validate_partial_sharding(dp, shard, k * 2)
    groups = zero.spliceable_groups(dp, shard)
    assert len(groups) == shard
    assert sorted(sum(groups, [])) == list(range(dp))


# ---------------------------------------------------------------------------
# Both packages, one seeded run: the same metrics and parameters
# ---------------------------------------------------------------------------

def _run(pkg, squash, update_fn, validate_every):
    t = _mod(pkg, "core.splicing").SplicedTrainer(
        n_ranks=4, seed=7, squash=squash, update_fn=update_fn)
    out = _mod(pkg, "core.validation").run_validated_training(
        t, 12, validate_every=validate_every)
    return (dataclasses.asdict(t.device.metrics),
            [t.params(r) for r in range(4)],
            [t.stable_addresses(r) for r in range(4)],
            out["squash_disabled"],
            [(r.ok, r.n_ranks_checked) for r in out["reports"]])


@pytest.mark.parametrize("squash,update_fn,validate_every", [
    (True, None, 3), (False, None, 4), (True, _bad_update, 2)])
def test_seeded_spliced_runs_agree_across_packages(squash, update_fn,
                                                   validate_every):
    """12 validated mini-batches at 4 ranks from seed 7: SpliceMetrics,
    every rank's parameters (bit for bit), stable addresses, when squashing
    was disabled and the validation reports are the same from both."""
    want = _run("repro", squash, update_fn, validate_every)
    got = _run("repro_torch", squash, update_fn, validate_every)
    assert got[0] == want[0]
    assert got[0]["context_switches"] > 0
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2:] == want[2:]
