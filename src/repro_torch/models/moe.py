"""Mixture-of-Experts layer: top-k router and capacity-bounded dispatch
(port of ``repro.models.moe``).

The router, the token dropping and the expert FFN follow the JAX module to
the bit of its index arithmetic: experts padded to a multiple of
``EXPERT_PAD`` with router logits of -1e30, and the capacity counted over
the padded experts; each (token, choice) takes the running count of its
expert over the flattened (token-major) order as its slot; entries past
``capacity`` are dropped; the kept ones are scattered into (experts,
capacity, d) buffers, run through the expert FFN as batched matmuls,
gathered back and weighted by their routing weights.  JAX computes the
expert products outside any Pallas kernel; so does this.

Two choices differ from the JAX code and not in its results.  The padded
experts, which no token reaches, get no buffers and no weight copies: JAX
pads the expert weights so that a mesh's "model" axis splits them evenly.
And the scatter and gather are ``index_add_`` and ``index_select`` over
the flattened (expert, slot) rows, whose backward passes are a gather and
an atomic add, where advanced indexing's scatter and gather backward sort
their indices (most of a granite training step on an H100: ``PERF.md``).

Under a mesh (``parallel/constraints.use_mesh``) whose "model" axis
divides the padded experts, the layer runs JAX's expert-parallel branch:
the experts padded to a multiple of ``EXPERT_PAD`` are split over "model"
and each device dispatches its batch shard's tokens to its own experts
(``shard_map``, with its expert offset, JAX's ``e_offset``); the partial
outputs are summed over "model" by the ``constrain`` after it (JAX's
``psum``).  The routing runs row by row on each batch shard; the aux loss
is taken over the global batch, as in JAX.  Where "model" does not divide
the experts, JAX's single-shard path runs on tokens gathered over the
batch axes: its capacity and slot order are those of the global batch.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_mlp, mlp_forward
from repro_torch.parallel.constraints import (BATCH, MODEL, constrain,
                                              current_mesh, is_dtensor,
                                              mesh_axis_sizes, shard_map)
from repro_torch.utils.spans import span

EXPERT_PAD = 16   # expert count padded to a multiple of this (granite 40->48)

# Fuse the wi/wg up-projections into one matmul over concatenated weights
# (the capacity buffer read once, not twice); off, as in JAX.
FUSED_GATE = False


def init_moe(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             moe: MoEConfig, *, device, dtype=torch.float32) -> Dict:
    """The JAX tree: ``router`` (d, E), stacked experts ``wi`` (E, d, f),
    ``wo`` (E, f, d) and, for SwiGLU, ``wg`` (E, d, f); ``shared`` when the
    config has a shared expert."""
    e, f = moe.num_experts, d_ff

    def init(shape, scale=0.02):
        return dense_init(gen, shape, scale, device=device, dtype=dtype)

    params = {
        "router": init((d_model, e)),
        "wi": init((e, d_model, f)),
        "wo": init((e, f, d_model), 0.02 / math.sqrt(2.0)),
    }
    if kind == "swiglu":
        params["wg"] = init((e, d_model, f))
    if moe.shared_expert_ff:
        params["shared"] = init_mlp(gen, d_model, moe.shared_expert_ff, kind,
                                    device=device, dtype=dtype)
    return params


def _router_logits(xf: torch.Tensor, router: torch.Tensor, epad: int
                   ) -> torch.Tensor:
    """(t, E + epad) router logits; the padded experts get -1e30: never
    selected, no flow."""
    logits = xf @ router.to(xf.dtype)
    if epad:
        logits = torch.cat([logits, logits.new_full((xf.shape[0], epad),
                                                    -1e30)], -1)
    return logits


def _top_k(logits: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(weights (T, k) f32, indices (T, k), probs (T, E) f32): an f32
    softmax; the k largest probabilities, ties to the lower index as
    ``jax.lax.top_k`` breaks them (a stable descending sort); the weights
    renormalised over the k."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    return w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9), idx, probs


def router_topk(logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T, k) f32, indices (T, k), aux loss):
    ``_top_k``, and the Switch aux loss E * sum_e f_e p_e on the top-1
    assignment, E counting the padded experts as JAX does.
    """
    w, idx, probs = _top_k(logits, top_k)
    e = logits.shape[-1]
    me = probs.mean(dim=0)                                      # mean prob
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)            # top-1 share
    return w, idx, e * torch.sum(me * ce)


def dispatch(idx: torch.Tensor, e_loc: int, capacity: int,
             e_offset: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(expert, slot, keep) of each flattened (token, choice) entry: the
    slot is the running count of its expert over the token-major order;
    entries past ``capacity``, or of an expert outside the ``e_loc`` held
    here (from ``e_offset``; a padded one), are not kept and point at
    (0, 0)."""
    flat_idx = idx.reshape(-1) - e_offset
    mine = (flat_idx >= 0) & (flat_idx < e_loc)
    safe_idx = torch.where(mine, flat_idx, 0)
    # JAX's cumsum(one_hot(safe_idx) * mine, axis=0) - 1, taken at each
    # entry's expert; laid out (experts, entries), so the scan runs along
    # the contiguous axis
    experts = torch.arange(e_loc, device=idx.device)[:, None]
    hits = (safe_idx[None, :] == experts) & mine[None, :]
    pos = hits.cumsum(dim=1).gather(0, safe_idx[None, :])[0] - 1
    keep = mine & (pos < capacity)
    return torch.where(keep, safe_idx, 0), torch.where(keep, pos, 0), keep


def _local_expert_ffn(xf: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor, wi: torch.Tensor,
                      wg: torch.Tensor, wo: torch.Tensor, *, k: int,
                      capacity: int, kind: str, e_offset: int = 0
                      ) -> torch.Tensor:
    """Dispatch, expert FFN and combine over the experts held here.

    xf: (t, d) tokens; idx/weights: (t, k) routing over all experts;
    wi/wg/wo: the experts held here (e_loc, ...), from ``e_offset``.
    Returns the (t, d) sum over them.
    """
    t, d = xf.shape
    e_loc = wi.shape[0]
    with span("moe.dispatch"):
        safe_e, safe_p, keep = dispatch(idx, e_loc, capacity, e_offset)
        contrib = torch.where(keep[:, None], xf.repeat_interleave(k, dim=0),
                              0)
        rows = safe_e * capacity + safe_p
        # dropped entries add zeros at row (0, 0): accumulate, never assign;
        # each kept row gets one entry, so the sum is exact in any order
        buf = xf.new_zeros((e_loc * capacity, d)).index_add_(
            0, rows, contrib).view(e_loc, capacity, d)

    if kind == "swiglu" and FUSED_GATE:
        hg = torch.bmm(buf, torch.cat([wi, wg], dim=-1).to(xf.dtype))
        f = wi.shape[-1]
        h = F.silu(hg[..., f:]) * hg[..., :f]
    else:
        h = torch.bmm(buf, wi.to(xf.dtype))
        if kind == "swiglu":
            h = F.silu(torch.bmm(buf, wg.to(xf.dtype))) * h
        else:
            h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    out_buf = torch.bmm(h, wo.to(xf.dtype))

    with span("moe.combine"):
        gathered = out_buf.reshape(-1, d).index_select(0, rows)  # (t k, d)
        wk = (weights.reshape(-1) * keep).to(xf.dtype)
        return (gathered * wk[:, None]).reshape(t, k, d).sum(dim=1)


def moe_forward(params: Dict, x: torch.Tensor, kind: str, moe: MoEConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out (B, S, d), aux loss * router_aux_weight).

    The capacity is JAX's single-shard one, max(ceil(t k / E_tot * cf), k)
    over the t = B S tokens of the call: a decode step routes its B
    tokens with their own capacity.
    """
    b, s, d = x.shape
    t = b * s
    e, k = moe.num_experts, moe.top_k
    epad = (-e) % EXPERT_PAD
    xf = x.reshape(t, d)
    if current_mesh() is not None and is_dtensor(x):
        out, aux = _moe_sharded(params, xf, kind, moe)
        if "shared" in params:
            out = out + mlp_forward(params["shared"], xf[None], kind)[0]
        return out.reshape(b, s, d), aux * moe.router_aux_weight

    logits = _router_logits(xf, params["router"], epad)
    e_tot = e + epad
    weights, idx, aux = router_topk(logits, k)
    weights = weights.to(x.dtype)

    # the e real experts only: no index reaches a padded one
    wi, wo = params["wi"], params["wo"]
    wg = params.get("wg", wi)  # unused for gelu
    capacity = max(int(math.ceil(t * k / e_tot * moe.capacity_factor)), k)
    out = _local_expert_ffn(xf, idx, weights, wi, wg, wo, k=k,
                            capacity=capacity, kind=kind)
    if "shared" in params:
        out = out + mlp_forward(params["shared"], xf[None], kind)[0]
    return out.reshape(b, s, d), aux * moe.router_aux_weight


def _pad_experts(w: torch.Tensor, epad: int) -> torch.Tensor:
    """``w`` (E, ...) with ``epad`` zero experts after the real ones (JAX's
    ``padw``); a split of the expert dim is undone first."""
    from torch.distributed.tensor import Replicate, Shard

    if not epad:
        return w
    if any(isinstance(pl, Shard) and pl.dim == 0 for pl in w.placements):
        w = w.redistribute(w.device_mesh, [
            Replicate() if isinstance(pl, Shard) and pl.dim == 0 else pl
            for pl in w.placements])
    return torch.cat([w, w.new_zeros((epad, *w.shape[1:]))], dim=0)


def _moe_sharded(params: Dict, xf: torch.Tensor, kind: str, moe: MoEConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer on DTensors under the ambient mesh: (out (t, d) over the
    batch axes, unweighted aux loss)."""
    mesh = current_mesh()
    sizes = mesh_axis_sizes(mesh)
    t, d = xf.shape
    e, k = moe.num_experts, moe.top_k
    epad = (-e) % EXPERT_PAD
    e_tot = e + epad
    m = sizes.get("model", 1)
    n_batch = 1
    for a in BATCH:
        n_batch *= sizes.get(a, 1)
    rows = (BATCH, None)
    dtype = xf.dtype

    def route(xf_, router_):
        w, idx, probs = _top_k(_router_logits(xf_, router_, epad), k)
        return w.to(dtype), idx, probs, F.one_hot(idx[:, 0], e_tot).float()

    ep = m > 1 and e_tot % m == 0 and t % n_batch == 0
    tok = rows if ep else (None, None)
    xf = constrain(xf, *tok)
    weights, idx, probs, top1 = shard_map(
        route, (xf, params["router"]), (tok, (None, None)),
        (0, (tok, (t, k)), (tok, (t, e_tot)), (tok, (t, e_tot))))
    # the Switch aux loss over the global batch: E sum_e f_e p_e
    aux = e_tot * torch.sum(probs.mean(dim=0) * top1.mean(dim=0))

    wi = _pad_experts(params["wi"], epad)
    wo = _pad_experts(params["wo"], epad)
    wg = _pad_experts(params["wg"], epad) if "wg" in params else wi
    experts = (MODEL, None, None) if ep else (None, None, None)
    tl = t // n_batch if ep else t
    capacity = max(int(math.ceil(tl * k / e_tot * moe.capacity_factor)), k)

    def ffn(xf_, idx_, w_, wi_, wg_, wo_):
        e_off = mesh.get_local_rank("model") * wi_.shape[0] if ep else 0
        return _local_expert_ffn(xf_, idx_, w_, wi_, wg_, wo_, k=k,
                                 capacity=capacity, kind=kind,
                                 e_offset=e_off)

    out = shard_map(ffn, (xf, idx, weights, wi, wg, wo),
                    (tok, tok, tok, experts, experts, experts), (0,),
                    partial=("model",) if ep else ())
    return constrain(out, BATCH, None), aux
