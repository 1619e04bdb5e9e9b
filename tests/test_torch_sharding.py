"""The port's placement rules, planner and op counter against the JAX
package's, on the CPU:

- ``param_specs``, ``decode_state_specs`` and ``batch_specs`` leaf for leaf
  on the full-size states of all ten ``ASSIGNED_ARCHS`` (JAX's
  ``eval_shape`` trees, the port's on the ``meta`` device), on the (1, 1),
  (2, 4), (16, 16) and (2, 16, 16) meshes, with both profiles.  The rules
  read only the mesh's axis names and sizes, so a stand-in mesh with no
  devices serves both packages;
- ``partial_shard_specs`` and ``shard_slice``; ``constrain`` outside a mesh;
- ``tests/test_launch_plan.py``'s six tests on both packages;
- the FLOP cases of ``tests/test_sharding_and_analysis.py``: ``op_cost``
  on eager loops of matmuls against ``analyze_hlo`` on JAX's jitted scans.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.launch.mesh as jax_mesh
import repro.launch.specs as jax_specs
import repro_torch.launch.mesh as torch_mesh
import repro_torch.launch.specs as torch_specs
from repro.analysis.hlo_cost import analyze_hlo
from repro.configs import ASSIGNED_ARCHS
from repro.configs.base import INPUT_SHAPES
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.optim import zero as jax_zero
from repro.parallel import sharding as jax_sharding
from repro_torch.analysis.op_cost import OpCost
from repro_torch.configs.base import TrainConfig
from repro_torch.optim import zero as torch_zero
from repro_torch.parallel import sharding as torch_sharding
from repro_torch.parallel.constraints import constrain


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (2, 4)),
          (("data", "model"), (16, 16)), (("pod", "data", "model"),
                                          (2, 16, 16))]
PROFILES = ("default", "replicate_model")
SHAPES = {s.name: s for s in INPUT_SHAPES}


def _stand_in(names, shape):
    """A mesh with only what the rules read: JAX's ``axis_names`` and
    ``devices.shape``, the port's ``axis_names`` and ``shape``."""
    return types.SimpleNamespace(
        axis_names=names, shape=shape,
        devices=types.SimpleNamespace(shape=shape))


def _jax_tuples(tree):
    """JAX's spec tree with each ``PartitionSpec`` as a tuple."""
    return jax.tree_util.tree_map(tuple, tree,
                                  is_leaf=lambda x: isinstance(x, P))


def _both(arch):
    """(JAX trees, port trees) of the arch: train state, decode state at
    decode_32k, and the batches of the three kinds of shape."""
    out = []
    for mod, tcfg in ((jax_specs, JaxTrainConfig()),
                      (torch_specs, TrainConfig())):
        plan = mod.plan_pair(arch, "train_4k")
        dplan = mod.plan_pair(arch, "decode_32k")
        batches = {name: mod.input_specs(plan.cfg, SHAPES[name])
                   for name in ("train_4k", "prefill_32k", "decode_32k")}
        out.append((mod.state_specs(plan.cfg, tcfg),
                    mod.decode_specs(dplan.cfg, dplan.shape), batches))
    return out


@pytest.fixture(scope="module")
def trees():
    return {arch: _both(arch) for arch in ASSIGNED_ARCHS}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_specs_equal_jax(trees, arch):
    """Every leaf's spec equal to JAX's, for the train state (params, m,
    v, count, step), the decode state and the batches, on the four meshes
    and both profiles."""
    (jstate, jdec, jbatch), (tstate, tdec, tbatch) = trees[arch]
    batch = SHAPES["decode_32k"].global_batch
    for names, shape in MESHES:
        mesh = _stand_in(names, shape)
        for profile in PROFILES:
            assert torch_sharding.param_specs(tstate, mesh, profile) == \
                _jax_tuples(jax_sharding.param_specs(jstate, mesh, profile))
            assert torch_sharding.decode_state_specs(
                tdec, mesh, batch, profile) == _jax_tuples(
                    jax_sharding.decode_state_specs(jdec, mesh, batch,
                                                    profile))
        for name in tbatch:
            assert torch_sharding.batch_specs(tbatch[name], mesh) == \
                _jax_tuples(jax_sharding.batch_specs(jbatch[name], mesh))


@pytest.mark.parametrize("shard_factor", [1, 2, 4, 8])
def test_partial_shard_specs_equal_jax(trees, shard_factor):
    (jstate, _, _), (tstate, _, _) = trees["granite-moe-3b-a800m"]
    assert torch_zero.partial_shard_specs(tstate["params"], shard_factor) == \
        _jax_tuples(jax_zero.partial_shard_specs(jstate["params"],
                                                 shard_factor))


def test_shard_slice_equal_jax():
    leaf = np.arange(6 * 8 * 4, dtype=np.float32).reshape(6, 8, 4)
    for spec in [(None, "data", None), (None, None, "data"), (), (None,)]:
        for idx in range(2):
            np.testing.assert_array_equal(
                torch_zero.shard_slice(torch.from_numpy(leaf), spec, idx,
                                       2).numpy(),
                jax_zero.shard_slice(leaf, P(*spec), idx, 2))


def test_constrain_noop_without_mesh():
    x = torch.ones(4, 4)
    assert constrain(x, "data", "model") is x


# ----------------------------------------- tests/test_launch_plan.py's six
PKGS = {"jax": (jax_specs, JaxTrainConfig), "torch": (torch_specs,
                                                      TrainConfig)}


@pytest.mark.parametrize("pkg", PKGS)
def test_all_40_pairs_planned(pkg):
    mod = PKGS[pkg][0]
    planned = skipped = 0
    for arch in ASSIGNED_ARCHS:
        for shape in INPUT_SHAPES:
            plan = mod.plan_pair(arch, shape.name)
            if plan.skip_reason:
                skipped += 1
                assert arch == "whisper-base" and shape.name == "long_500k"
            else:
                planned += 1
    assert planned == 39 and skipped == 1


@pytest.mark.parametrize("pkg", PKGS)
def test_long_context_is_subquadratic(pkg):
    """Every non-skipped long_500k plan has O(window) or O(1) state."""
    mod = PKGS[pkg][0]
    for arch in ASSIGNED_ARCHS:
        plan = mod.plan_pair(arch, "long_500k")
        if plan.skip_reason:
            continue
        cfg = plan.cfg
        assert cfg.arch_type == "ssm" or cfg.sliding_window > 0, arch
        if plan.swa_variant:
            assert cfg.sliding_window == mod.SWA_VARIANT_WINDOW


@pytest.mark.parametrize("pkg", PKGS)
def test_decode_cache_sized_by_window(pkg):
    mod = PKGS[pkg][0]
    plan = mod.plan_pair("yi-9b", "long_500k")          # SWA variant
    st = mod.decode_specs(plan.cfg, plan.shape)
    assert st["kv"]["k"].shape[2] == mod.SWA_VARIANT_WINDOW
    plan2 = mod.plan_pair("yi-9b", "decode_32k")        # full attention
    st2 = mod.decode_specs(plan2.cfg, plan2.shape)
    assert st2["kv"]["k"].shape[2] == 32_768


@pytest.mark.parametrize("pkg", PKGS)
def test_input_specs_shapes(pkg):
    mod = PKGS[pkg][0]
    plan = mod.plan_pair("llama-3.2-vision-11b", "train_4k")
    specs = mod.input_specs(plan.cfg, plan.shape)
    assert tuple(specs["tokens"].shape) == (256, 4096)
    assert tuple(specs["labels"].shape) == (256, 4096)
    assert tuple(specs["image_embeds"].shape) == (256, 1601, 1280)

    dplan = mod.plan_pair("olmo-1b", "decode_32k")
    dspecs = mod.input_specs(dplan.cfg, dplan.shape)
    assert tuple(dspecs["token"].shape) == (128,)


@pytest.mark.parametrize("pkg", PKGS)
def test_state_specs_no_allocation(pkg):
    """Abstract state specs (JAX: ShapeDtypeStruct; the port: meta
    tensors, no storage): granite-8b's ~8B parameters, never allocated."""
    mod, tcfg = PKGS[pkg]
    plan = mod.plan_pair("granite-8b", "train_4k")
    st = mod.state_specs(plan.cfg, tcfg())
    if pkg == "jax":
        leaves = jax.tree_util.tree_leaves(st["params"])
        assert isinstance(leaves[0], jax.ShapeDtypeStruct)
    else:
        leaves = [t for t in torch.utils._pytree.tree_leaves(st["params"])
                  if t is not None]
        assert all(t.device.type == "meta" for t in leaves)
    total = sum(int(np.prod(leaf.shape)) for leaf in leaves)
    assert total > 5e9


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_local_mesh(pkg):
    if pkg == "jax":
        assert jax_mesh.make_local_mesh().devices.size == 1
        return
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = torch_mesh.make_local_mesh("cpu")
        assert mesh.size() == 1 and mesh.mesh_dim_names == ("data", "model")
    finally:
        dist.destroy_process_group()


# ------------------------- op_cost against analyze_hlo (FLOPs, 1% bound)
def _torch_flops(fn, *args):
    with OpCost() as counter:
        fn(*args)
    return counter.cost.flops


def test_flops_single_dot():
    a, b, k = 32, 48, 64
    hlo = jax.jit(lambda x, y: x @ y).lower(
        jnp.zeros((a, k)), jnp.zeros((k, b))).compile().as_text()
    want = analyze_hlo(hlo).flops
    got = _torch_flops(torch.matmul, torch.zeros(a, k), torch.zeros(k, b))
    assert got == 2 * a * b * k and abs(got - want) / want < 0.01


def test_flops_loop_of_matmuls():
    """N matmuls in an eager loop against a jitted scan of N."""
    n, m = 8, 64

    def scanned(x, ws):
        y, _ = jax.lax.scan(lambda c, w: (c @ w, None), x, ws)
        return y

    hlo = jax.jit(scanned).lower(jnp.zeros((m, m)),
                                 jnp.zeros((n, m, m))).compile().as_text()
    want = analyze_hlo(hlo).flops

    def loop(x, ws):
        for w in ws:
            x = x @ w
        return x

    got = _torch_flops(loop, torch.zeros(m, m), torch.zeros(n, m, m))
    assert abs(got - want) / want < 0.01, (got, want)


def test_flops_nested_loops():
    m = 16

    def inner(x, ws):
        y, _ = jax.lax.scan(lambda c, w: (c @ w, None), x, ws)
        return y

    def outer(x, ws):
        y, _ = jax.lax.scan(lambda c, w: (inner(c, w), None), x, ws)
        return y

    hlo = jax.jit(outer).lower(jnp.zeros((m, m)),
                               jnp.zeros((3, 5, m, m))).compile().as_text()
    want = analyze_hlo(hlo).flops

    def nested(x, ws):
        for group in ws:
            for w in group:
                x = x @ w
        return x

    got = _torch_flops(nested, torch.zeros(m, m), torch.zeros(3, 5, m, m))
    assert got == 15 * 2 * m ** 3 and abs(got - want) / want < 0.01
