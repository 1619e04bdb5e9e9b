"""The port's MoE family against the JAX package's, on the CPU at f32.

- ``router_topk``: the same indices (ties to the lower index, as
  ``jax.lax.top_k``), weights and aux loss from the same logits;
- ``dispatch`` and ``moe_forward`` with drops forced by a small capacity
  factor: the kept mask equal to the one JAX's own ``_local_expert_ffn``
  applies (read off ``jax.grad`` in the routing weights, which is exactly
  zero at a dropped entry), outputs and aux loss close;
- the granite-moe-3b-a800m and qwen3-moe-30b-a3b smoke configs (2 layers,
  d 256, 4 heads, 1 KV head, 4 experts padded to 16, top-2): every token of
  every layer routed to the same experts in prefill and decode, prefill and
  decode state, greedy tokens;
- granite's ``model_forward`` loss (aux included) and gradients, remat on
  and off, against ``jax.value_and_grad``, one spliced train step and
  5-step ``ElasticRuntime`` trajectories at splice 1 and 2;
- the bridge: MoE and hybrid train states across and back bit for bit.

The JAX package draws the weights and the bridge moves them bit for bit;
inputs come from numpy seeds.  Routing is compared exactly; each test
prints the smallest gap between the k-th and the (k+1)-th router
probability it saw, so that a mismatch could be told from a near tie.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as jax_moe
import repro_torch.models.moe as moe
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.elastic import ElasticRuntime as JaxElasticRuntime
from repro.models import decode_step_fn as jax_decode_step_fn
from repro.models import model_forward as jax_model_forward
from repro.models import prefill_fn as jax_prefill_fn
from repro.serving.engine import ServingEngine as JaxServingEngine
from repro.training.state import init_train_state as jax_init_train_state
from repro.training.step import build_train_step as jax_build_train_step
from repro_torch.bridge import (params_from_jax, params_to_numpy,
                                train_state_from_jax, train_state_to_numpy)
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import MoEConfig, TrainConfig
from repro_torch.core.elastic import ElasticRuntime
from repro_torch.models import (decode_step_fn, init_params, model_forward,
                                prefill_fn)
from repro_torch.serving.engine import ServingEngine
from repro_torch.training import build_train_step
from repro_torch.utils.tree import tree_flatten, tree_leaves
from test_torch_ssm_train import assert_first_adamw_step_close


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (see ``tests/test_torch_donate.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
B, S = 2, 40
TCFG = dict(total_steps=40, warmup_steps=2, learning_rate=1e-3)
# f32 on both sides, summed in other orders: outputs and logits at 1e-5
# of their largest entry (tests/test_torch_train.py), state at 1e-4
F32_TOL = 1e-5
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch):
    return (dataclasses.replace(get_smoke_config(arch), dtype="float32"),
            dataclasses.replace(jax_smoke_config(arch), dtype="float32"))


def _close_rel(got, want, tol):
    """|got - want| <= tol * max |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol)


def _gap(probs, k):
    """Smallest gap between the k-th and (k+1)-th probability of a row."""
    top = np.sort(np.asarray(probs, np.float64), axis=-1)[:, ::-1]
    return float((top[:, k - 1] - top[:, k]).min())


@pytest.fixture(scope="module")
def jax_params_np():
    """Each arch's JAX weights (numpy), drawn once."""
    from repro.models import init_params as jax_init_params

    out = {}
    for arch in ARCHS:
        _, jcfg = _cfgs(arch)
        out[arch] = jax.tree_util.tree_map(
            np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    return out


def _same_tree(a, b, exact=True):
    """The same keys in the same order, ``None`` leaves, shapes, dtypes
    and (``exact``) values."""
    assert (a is None) == (b is None)
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for key in a:
            _same_tree(a[key], b[key], exact)
    elif a is not None:
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact:
            np.testing.assert_array_equal(a, b)


def _sorted(t):  # jax.vmap hands its dicts back in sorted-key order
    if isinstance(t, dict):
        return {k: _sorted(t[k]) for k in sorted(t)}
    return t


@pytest.mark.parametrize("arch", ARCHS + ["zamba2-1.2b"])
def test_bridge_carries_train_states_bit_for_bit(arch):
    """A JAX train state of the MoE family (stacked (L, E, d, f) experts,
    the router) or the hybrid one (``shared_attn``) crosses into the port
    and back bit for bit, keys and order kept; the port's own init has the
    JAX tree's keys, shapes and dtypes."""
    cfg, jcfg = _cfgs(arch)
    state_np = jax.tree_util.tree_map(np.asarray, jax_init_train_state(
        jcfg, JaxTrainConfig(**TCFG), jax.random.PRNGKey(0)))
    _same_tree(train_state_to_numpy(train_state_from_jax(state_np, cfg)),
               state_np)
    blocks = state_np["params"]["blocks"]
    if cfg.arch_type == "moe":
        e, f = cfg.moe.num_experts, cfg.d_ff
        assert blocks["moe"]["wi"].shape == (2, e, cfg.d_model, f)
        assert blocks["moe"]["router"].shape == (2, cfg.d_model, e)
    else:
        assert "shared_attn" in state_np["params"]
    ours = params_to_numpy(init_params(cfg, 0, device="cpu"))
    _same_tree(_sorted(ours), _sorted(state_np["params"]), exact=False)


# ---------------------------------------------------------------------------
# The router and the dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,e,k", [(64, 16, 2), (200, 48, 8), (33, 128, 8)])
def test_router_topk_matches_jax(t, e, k):
    """Indices exactly, weights at 1e-6, aux at 1e-6 relative; a quarter of
    the rows carry exact ties (a duplicated logit, and the -1e30 of padded
    experts), which both break toward the lower index."""
    rng = np.random.default_rng(t)
    logits = rng.standard_normal((t, e)).astype(np.float32)
    logits[::4, 3] = logits[::4, 1]           # exact ties
    logits[:, e - e // 8:] = -1e30            # padded experts
    w, idx, aux = moe.router_topk(torch.from_numpy(logits), k)
    jw, jidx, jaux = jax_moe.router_topk(jnp.asarray(logits), k)
    print(f"T={t} E={e} k={k}: smallest gap between the k-th and (k+1)-th "
          f"probability {_gap(jax.nn.softmax(logits), k)!r}")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


def _jax_keep(xf, idx, weights, wi, wg, wo, k, capacity, kind):
    """The kept mask that JAX's own ``_local_expert_ffn`` applies: its
    output depends on weights[t, j] only through weights * keep, so the
    gradient of a random projection of it is exactly zero where an entry
    is dropped (and, with random inputs, nonzero where it is kept)."""
    r = np.random.default_rng(5).standard_normal(xf.shape).astype(np.float32)

    def f(w):
        out = jax_moe._local_expert_ffn(
            xf, idx, w, wi, wg, wo, k=k, capacity=capacity, kind=kind,
            e_offset=jnp.int32(0), axis_name=None)
        return jnp.sum(out * r)

    return np.asarray(jax.grad(f)(weights)).reshape(-1) != 0


@pytest.mark.parametrize("kind,cf", [("swiglu", 0.5), ("gelu", 0.3),
                                     ("swiglu", 1.25)])
def test_dispatch_and_moe_forward_match_jax(kind, cf):
    """40 experts (padded to 48), top-8, 96 tokens of d 64: the kept mask
    equal to JAX's entry for entry (at factors 0.5 and 0.3 drops are
    forced; at 1.25 this peaked router still drops some); outputs at 1e-5
    of their largest entry, aux at 1e-5."""
    t, d, f, e, k = 96, 64, 32, 40, 8
    cfg = MoEConfig(num_experts=e, top_k=k, capacity_factor=cf)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, t // 2, d)).astype(np.float32)
    params = {"router": 0.3 * rng.standard_normal((d, e)),
              "wi": 0.1 * rng.standard_normal((e, d, f)),
              "wo": 0.1 * rng.standard_normal((e, f, d))}
    if kind == "swiglu":
        params["wg"] = 0.1 * rng.standard_normal((e, d, f))
    params = {key: val.astype(np.float32) for key, val in params.items()}
    tparams = {key: torch.from_numpy(val) for key, val in params.items()}
    jparams = {key: jnp.asarray(val) for key, val in params.items()}

    out, aux = moe.moe_forward(tparams, torch.from_numpy(x), kind, cfg)
    jout, jaux = jax_moe.moe_forward(jparams, jnp.asarray(x), kind, cfg)
    _close_rel(out.numpy(), jout, F32_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)

    # the routing and the kept mask of that call, both sides
    e_tot = e + (-e) % moe.EXPERT_PAD
    capacity = max(int(np.ceil(t * k / e_tot * cf)), k)
    xf = x.reshape(t, d)
    logits = np.pad(xf @ params["router"], ((0, 0), (0, e_tot - e)),
                    constant_values=-1e30)
    w, idx, _ = moe.router_topk(torch.from_numpy(logits), k)
    jw, jidx, _ = jax_moe.router_topk(jnp.asarray(logits), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    pad = ((0, e_tot - e), (0, 0), (0, 0))
    wts = [jnp.asarray(np.pad(params[n], pad)) for n in (
        "wi", "wg" if kind == "swiglu" else "wi", "wo")]
    want_keep = _jax_keep(jnp.asarray(xf), jidx, jw, *wts, k, capacity, kind)
    _, _, keep = moe.dispatch(idx, e_tot, capacity)
    print(f"{kind} cf={cf}: capacity {capacity}, {int((~want_keep).sum())} "
          f"of {t * k} entries dropped; smallest gap between the k-th and "
          f"(k+1)-th probability {_gap(jax.nn.softmax(logits), k)!r}")
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if cf < 1:
        assert (~want_keep).any(), "a capacity factor under 1 drops"


# ---------------------------------------------------------------------------
# The smoke configs: routing, prefill/decode state, greedy tokens
# ---------------------------------------------------------------------------

@pytest.fixture
def routing_log(monkeypatch):
    """Records the (T, k) routing indices and probabilities of every
    ``router_topk`` call, the port's and (through a host callback inside
    the jitted program) JAX's, in call order."""
    logs = {"port": [], "jax": []}
    port_fn, jax_fn = moe.router_topk, jax_moe.router_topk

    def port(logits, top_k):
        w, idx, aux = port_fn(logits, top_k)
        logs["port"].append((idx.numpy().copy(),
                             torch.softmax(logits.float(), -1).numpy()))
        return w, idx, aux

    def jax_side(logits, top_k):
        w, idx, aux = jax_fn(logits, top_k)
        jax.debug.callback(
            lambda i, p: logs["jax"].append((np.asarray(i), np.asarray(p))),
            idx, jax.nn.softmax(logits.astype(jnp.float32)), ordered=True)
        return w, idx, aux

    monkeypatch.setattr(moe, "router_topk", port)
    monkeypatch.setattr(jax_moe, "router_topk", jax_side)
    return logs


def _assert_same_routing(logs, k):
    """Every call routed every token to the same experts; with equal
    indices and capacities ``dispatch`` keeps the same entries (held to
    JAX's own mask in ``test_dispatch_and_moe_forward_match_jax``)."""
    assert len(logs["port"]) == len(logs["jax"]) > 0
    gap = min(_gap(p, k) for _, p in logs["port"])
    print(f"{len(logs['port'])} router calls; smallest gap between the k-th "
          f"and (k+1)-th probability {gap!r}")
    for (idx, _), (jidx, _) in zip(logs["port"], logs["jax"]):
        np.testing.assert_array_equal(idx, jidx)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(jax_params_np, routing_log, arch):
    cfg, jcfg = _cfgs(arch)
    jp = jax_params_np[arch]
    params = params_from_jax(jp, cfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, jp)
    tokens = np.random.default_rng(0).integers(0, 512, (B, S + 1),
                                               dtype=np.int32)
    prompt = tokens[:, :S]
    logits, state = prefill_fn(params, {"tokens": torch.from_numpy(prompt)},
                               cfg, cache_len=S + 4)
    jlogits, jstate = jax.jit(
        lambda p, t: jax_prefill_fn(p, {"tokens": t}, jcfg, cache_len=S + 4))(
        jparams, jnp.asarray(prompt))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert state["pos"] == int(jstate["pos"]) == S
    assert sorted(state) == sorted(jstate) == ["kv", "pos"]
    for name in ("k", "v"):
        assert state["kv"][name].shape == jstate["kv"][name].shape
        np.testing.assert_allclose(state["kv"][name].numpy(),
                                   np.asarray(jstate["kv"][name]), **TOL)

    nxt = tokens[:, S]
    dlogits, state = decode_step_fn(params, state, torch.from_numpy(nxt), cfg)
    jdlogits, _ = jax.jit(lambda p, st, t: jax_decode_step_fn(p, st, t, jcfg))(
        jparams, jstate, jnp.asarray(nxt))
    np.testing.assert_allclose(dlogits.numpy(), np.asarray(jdlogits), **TOL)
    jax.effects_barrier()
    # 2 layers of prefill (B S tokens), 2 of decode (B tokens)
    assert [len(i) for i, _ in routing_log["port"]] == [B * S] * 2 + [B] * 2
    _assert_same_routing(routing_log, cfg.moe.top_k)

    # decode-vs-prefill consistency: drops depend on the call's tokens (a
    # decode step routes B of them, a prefill B S), so at the capacity
    # factor of 64 that tests/test_decode_consistency.py gives MoE configs,
    # where nothing drops
    cfg64 = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=64.0))
    _, state = prefill_fn(params, {"tokens": torch.from_numpy(prompt)}, cfg64,
                          cache_len=S + 1)
    dec, _ = decode_step_fn(params, state, torch.from_numpy(nxt), cfg64)
    ref, _ = prefill_fn(params, {"tokens": torch.from_numpy(tokens)}, cfg64)
    np.testing.assert_allclose(dec.numpy(), ref.numpy(), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_tokens_match_jax(jax_params_np, routing_log, arch):
    cfg, jcfg = _cfgs(arch)
    jp = jax_params_np[arch]
    prompt = np.random.default_rng(2).integers(0, 512, (B, S),
                                               dtype=np.int32)
    ours = ServingEngine(cfg, params=params_from_jax(jp, cfg),
                         device="cpu").generate(prompt, max_new_tokens=6)
    want = JaxServingEngine(
        jcfg, params=jax.tree_util.tree_map(jnp.asarray, jp)).generate(
        jnp.asarray(prompt), max_new_tokens=6)
    jax.effects_barrier()
    assert ours.dtype == torch.int32 and ours.shape == (B, 6)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(want))
    _assert_same_routing(routing_log, cfg.moe.top_k)


# ---------------------------------------------------------------------------
# Training: the loss, its gradients and a spliced step
# ---------------------------------------------------------------------------

def _batch(seed, b=B, s=S):
    tok = np.random.default_rng(seed).integers(0, 512, (b, s + 1),
                                               dtype=np.int32)
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


@pytest.mark.parametrize("remat", [True, False])
def test_model_forward_loss_and_grads_match_jax(jax_params_np, remat):
    """granite smoke: loss (CE plus the two layers' aux) at 1e-5 relative,
    aux at 1e-5, every gradient leaf (the router's too) at 1e-5 of its
    largest entry."""
    arch = ARCHS[0]
    cfg, jcfg = _cfgs(arch)
    batch = _batch(0)
    params = params_from_jax(jax_params_np[arch], cfg)
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_()
    loss, metrics = model_forward(
        params, {k: torch.from_numpy(v).long() for k, v in batch.items()},
        cfg, remat=remat)
    loss.backward()
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_params_np[arch])
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model_forward(p, b, jcfg, remat=remat),
        has_aux=True))(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert metrics["aux"].item() > 0
    np.testing.assert_allclose(metrics["aux"].item(), float(jmetrics["aux"]),
                               rtol=1e-5)
    got, paths = tree_flatten(params)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    assert len(got) == len(jleaves) == 13
    names = ["/".join(path) for path in paths]
    assert "blocks/moe/router" in names
    for name, leaf, want in zip(names, got, jleaves):
        assert leaf.grad is not None and leaf.grad.dtype == torch.float32
        assert np.abs(np.asarray(want)).max() > 0, name
        _close_rel(leaf.grad.numpy(), want, F32_TOL)


@pytest.mark.parametrize("splice", [1, 2])
def test_train_step_matches_jax(splice):
    """One spliced step of granite smoke from one bridged state: loss, lr
    and grad_norm at 1e-5; m and v at 1e-5 of each leaf's largest entry;
    params as ``tests/test_torch_ssm_train.py`` holds AdamW's first step."""
    cfg, jcfg = _cfgs(ARCHS[0])
    state_np = jax.tree_util.tree_map(np.asarray, jax_init_train_state(
        jcfg, JaxTrainConfig(**TCFG), jax.random.PRNGKey(0)))
    batch = _batch(1, b=4, s=32)
    new, metrics = build_train_step(cfg, TrainConfig(**TCFG), splice=splice)(
        train_state_from_jax(state_np, cfg),
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    jnew, jmetrics = jax.jit(jax_build_train_step(
        jcfg, JaxTrainConfig(**TCFG), splice=splice))(
        jax.tree_util.tree_map(jnp.asarray, state_np),
        {k: jnp.asarray(v) for k, v in batch.items()})
    for key in ("loss", "lr", "grad_norm"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                   rtol=1e-5)
    got = train_state_to_numpy(new)
    want = jax.tree_util.tree_map(np.asarray, jnew)
    for part in ("m", "v"):
        for gl, wl in zip(jax.tree_util.tree_leaves(got["opt"][part]),
                          jax.tree_util.tree_leaves(want["opt"][part])):
            _close_rel(gl, wl, F32_TOL)
    lr = float(jmetrics["lr"])
    for gl, wl, gm, wm in zip(*(jax.tree_util.tree_leaves(t) for t in (
            got["params"], want["params"], got["opt"]["m"],
            want["opt"]["m"]))):
        assert_first_adamw_step_close(gl, wl, gm, wm, lr)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's granite smoke runtime: its initial state (numpy) and 5-step
    f32 loss trajectories at splice 1 and 2 (global batch 8 x 32)."""
    _, jcfg = _cfgs(ARCHS[0])
    runs = {}
    for physical in (4, 2):
        rt = JaxElasticRuntime(jcfg, JaxTrainConfig(**TCFG), 4, physical, 8,
                               32)
        runs[4 // physical] = [r["loss"] for r in rt.run_steps(5)]
    state = JaxElasticRuntime(jcfg, JaxTrainConfig(**TCFG), 4, 4, 8, 32).state
    return jax.tree_util.tree_map(np.asarray, state), runs


@pytest.mark.parametrize("splice", [1, 2])
def test_elastic_trajectory_matches_jax(jax_runs, splice):
    """5 steps through the port's ElasticRuntime from JAX's state: each
    loss at 1e-5 relative to JAX's.  The two splice factors' trajectories
    differ from each other, in JAX as here: each slice routes its own
    tokens, with its own capacity and its own aux loss."""
    state_np, runs = jax_runs
    cfg, _ = _cfgs(ARCHS[0])
    rt = ElasticRuntime(cfg, TrainConfig(**TCFG), 4, 4 // splice, 8, 32,
                        state=train_state_from_jax(state_np, cfg),
                        device="cpu")
    losses = [h["loss"] for h in rt.run_steps(5)]
    np.testing.assert_allclose(losses, runs[splice], rtol=1e-5)
    assert runs[1] != runs[2]
