"""The port's sharded execution on 8 CPU ranks (``torch.distributed`` over
gloo, one process and one thread per rank), as ``tests/test_multidevice.py``
runs the JAX step on 8 host devices (F0).

On a (2, 4) ("data", "model") mesh, the state and batch distributed by
``param_specs`` and ``batch_specs``:

- two steps of the olmo-1b smoke config give JAX's single-device losses to
  1e-4 relative (F0's bound; JAX's own sharded step fails on the installed
  JAX, so the reference is its single-device step).  At f32, the dtype of
  the port's parity runs: at bf16 the two frameworks round activations at
  other places, 1e-4 relative after two steps in this test's first run.
  The embedding gather is F0's layout (the table over ("model", "data"),
  the tokens over "data");
- the params after two steps equal the port's one-device step's within
  1e-4 absolute (0.1 lr: AdamW's first steps move an entry with a
  near-zero gradient by an amount that rests on its last bits);
- the summed barrier payload equals the one-device sum;
- a granite-moe smoke step takes the expert-parallel branch (4 experts
  padded to 16, 4 a shard of "model", offsets 0, 4, 8, 12) and its loss
  equals the one-device one to 1e-5 relative, at f32 and a capacity factor where
  nothing drops (each batch shard routes its own tokens: JAX's branch
  counts the capacity per shard);
- granite-moe's and mamba2-130m's smoke gradients equal the one-device
  ones: the inputs a ``shard_map`` holds replicated get their gradients
  summed over the axes the work is split on.
"""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.training.state import init_train_state as jax_init_train_state
from repro.training.step import build_train_step as jax_build_train_step
from repro_torch.bridge import train_state_from_jax, train_state_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import TrainConfig
from repro_torch.core.barrier_step import meta_allreduce
from repro_torch.training import (build_train_step, init_train_state,
                                  loss_and_grads)
from repro_torch.utils.tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = dict(total_steps=10, warmup_steps=1, learning_rate=1e-3)
RANKS, MESH = 8, (2, 4)
FLAGS = np.array([[1, 0], [1, 1]], dtype=np.int32)   # one row a data shard

WORKER = r"""
import sys
import torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, port, inp, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=%(ranks)d)
from repro_torch.bridge import train_state_from_jax
from repro_torch.configs.base import TrainConfig
from repro_torch.launch.mesh import MeshShape, make_mesh
from repro_torch.models import moe
from repro_torch.parallel.constraints import use_mesh
from repro_torch.parallel.sharding import (batch_specs, distribute_tree,
                                           param_specs)
from repro_torch.training import build_train_step, loss_and_grads
from repro_torch.utils.tree import tree_map

data = torch.load(inp, weights_only=False)
mesh = make_mesh(MeshShape(("data", "model"), %(mesh)r))

def place(tree):
    return distribute_tree(tree, param_specs(tree, mesh), mesh)

def batch(b):
    b = {k: torch.as_tensor(v).long() for k, v in b.items()}
    return distribute_tree(b, batch_specs(b, mesh), mesh)

cfg = data["cfg"]
state = place(train_state_from_jax(data["state"], cfg))
tokens = batch(data["batch"])
step = build_train_step(cfg, TrainConfig(**data["tcfg"]), with_barrier=True)
losses = []
with use_mesh(mesh):
    for _ in range(2):
        state, metrics = step(state, tokens, torch.as_tensor(data["flags"]))
        losses.append(float(metrics["loss"].full_tensor()))
params = tree_map(lambda t: t.full_tensor(), state["params"])

seen = []
local = moe._local_expert_ffn
def spy(*args, **kwargs):
    seen.append((int(args[3].shape[0]), int(kwargs["e_offset"])))
    return local(*args, **kwargs)
moe._local_expert_ffn = spy

mloss, grads = {}, {}
for name in ("granite", "mamba2"):
    mcfg = data[name + "_cfg"]
    mparams = place(train_state_from_jax(data[name + "_state"], mcfg)["params"])
    with use_mesh(mesh):
        loss, g = loss_and_grads(mparams, batch(data["gbatch"]), mcfg,
                                 TrainConfig())
    mloss[name] = float(loss.full_tensor())
    grads[name] = tree_map(lambda t: t.full_tensor(), g)
if rank == 0:
    torch.save({"losses": losses, "params": params,
                "barrier": metrics["barrier"], "mloss": mloss,
                "grads": grads}, out)
torch.save(seen, out + f".seen{rank}")
dist.destroy_process_group()
""" % {"ranks": RANKS, "mesh": MESH}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(inp, out):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    port = str(_free_port())
    return [subprocess.Popen([sys.executable, "-c", WORKER, str(r), port,
                              inp, out], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
            for r in range(RANKS)]


def _wait(procs):
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's single-device losses, the port's one-device results and the 8
    ranks' results (the ranks run while the references are computed)."""
    tmp = tmp_path_factory.mktemp("multidevice")
    jcfg = dataclasses.replace(jax_smoke_config("olmo-1b"), dtype="float32")
    key = jax.random.PRNGKey(0)
    jstate = jax_init_train_state(jcfg, JaxTrainConfig(**TCFG), key)
    tokens = jax.random.randint(key, (8, 64), 0, jcfg.vocab_size)
    jbatch = {"tokens": tokens, "labels": tokens}
    state_np = jax.tree_util.tree_map(np.asarray, jstate)
    batch_np = {k: np.asarray(v) for k, v in jbatch.items()}

    cfg = dataclasses.replace(get_smoke_config("olmo-1b"), dtype="float32")
    gcfg = get_smoke_config("granite-moe-3b-a800m")
    gcfg = dataclasses.replace(gcfg, dtype="float32", moe=dataclasses.replace(
        gcfg.moe, capacity_factor=64.0))
    gstate = init_train_state(gcfg, TrainConfig(), device="cpu")
    gtok = torch.randint(0, gcfg.vocab_size, (8, 64),
                         generator=torch.Generator().manual_seed(1))
    mcfg = dataclasses.replace(get_smoke_config("mamba2-130m"),
                               dtype="float32")
    mstate = init_train_state(mcfg, TrainConfig(), device="cpu")
    inp, out = str(tmp / "in.pt"), str(tmp / "out.pt")
    torch.save({"cfg": cfg, "state": state_np, "batch": batch_np,
                "tcfg": TCFG, "flags": FLAGS, "granite_cfg": gcfg,
                "granite_state": train_state_to_numpy(gstate),
                "mamba2_cfg": mcfg,
                "mamba2_state": train_state_to_numpy(mstate),
                "gbatch": {"tokens": gtok.numpy(), "labels": gtok.numpy()}},
               inp)
    procs = _launch(inp, out)

    jstep = jax.jit(jax_build_train_step(jcfg, JaxTrainConfig(**TCFG)))
    s1, m1 = jstep(jstate, jbatch)
    _, m2 = jstep(s1, jbatch)
    jax_losses = [float(m1["loss"]), float(m2["loss"])]
    step = build_train_step(cfg, TrainConfig(**TCFG))
    one = train_state_from_jax(state_np, cfg)
    tb = {k: torch.from_numpy(v).long() for k, v in batch_np.items()}
    for _ in range(2):
        one, _ = step(one, tb)
    ref = {name: loss_and_grads(st["params"],
                                {"tokens": gtok, "labels": gtok}, c,
                                TrainConfig())
           for name, c, st in (("granite", gcfg, gstate),
                               ("mamba2", mcfg, mstate))}

    _wait(procs)
    sharded = torch.load(out, weights_only=False)
    sharded["seen"] = [torch.load(f"{out}.seen{r}", weights_only=False)
                       for r in range(RANKS)]
    return jax_losses, one, ref, sharded


def test_losses_match_jax_single_device(runs):
    jax_losses, _, _, sharded = runs
    for a, b in zip(jax_losses, sharded["losses"]):
        assert abs(a - b) / abs(a) < 1e-4, (jax_losses, sharded["losses"])


def test_params_match_one_device(runs):
    _, one, _, sharded = runs
    for a, b in zip(tree_leaves(sharded["params"]),
                    tree_leaves(one["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4)


def test_barrier_sums_over_data(runs):
    summed = runs[3]["barrier"]
    assert summed.tolist() == FLAGS.sum(axis=0).tolist()
    assert meta_allreduce(torch.as_tensor(FLAGS)).tolist() == \
        summed.tolist()


def test_expert_parallel_forward(runs):
    """Each layer's forward and its recomputation under remat (2 x 2
    calls) dispatch to the rank's 4 of 16 padded experts."""
    _, _, ref, sharded = runs
    for rank, seen in enumerate(sharded["seen"]):
        offset = 4 * (rank % MESH[1])      # the rank's "model" coordinate
        assert seen == [(4, offset)] * 4, (rank, seen)
    np.testing.assert_allclose(sharded["mloss"]["granite"],
                               float(ref["granite"][0]), rtol=1e-5)


@pytest.mark.parametrize("name", ["granite", "mamba2"])
def test_sharded_gradients(runs, name):
    """f32 smoke gradients of granite-moe (the expert-parallel branch: the
    expert weights' gradients summed over "data", the tokens' over
    "model") and mamba2-130m (the SSD scan per head shard: A's gradient
    summed over "data", B's and C's over "model"), remat on, equal to the
    one-device ones within 1e-5 of each leaf's largest entry."""
    _, _, ref, sharded = runs
    np.testing.assert_allclose(sharded["mloss"][name], float(ref[name][0]),
                               rtol=1e-5)
    got = tree_leaves(sharded["grads"][name])
    want = tree_leaves(ref[name][1])
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        scale = float(b.abs().max())
        assert scale > 0
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale,
                                   rtol=0, atol=1e-5)
