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

One device: the JAX module's ``shard_map`` branch (expert-parallel
dispatch over a mesh's "model" axis, ROADMAP M9) has no counterpart;
its single-shard path is this one.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import dense_init
from repro_torch.models.mlp import init_mlp, mlp_forward

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


def router_topk(logits: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """logits (T, E) -> (weights (T, k) f32, indices (T, k), aux loss).

    An f32 softmax; the k largest probabilities, ties to the lower index
    as ``jax.lax.top_k`` breaks them (a stable descending sort); the
    weights renormalised over the k; the Switch aux loss E * sum_e f_e p_e
    on the top-1 assignment, E counting the padded experts as JAX does.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :top_k], idx[:, :top_k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    me = probs.mean(dim=0)                                      # mean prob
    ce = F.one_hot(idx[:, 0], e).float().mean(dim=0)            # top-1 share
    return w, idx, e * torch.sum(me * ce)


def dispatch(idx: torch.Tensor, e_loc: int, capacity: int
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(expert, slot, keep) of each flattened (token, choice) entry: the
    slot is the running count of its expert over the token-major order;
    entries past ``capacity``, or of an expert outside the ``e_loc`` held
    here (a padded one), are not kept and point at (0, 0)."""
    flat_idx = idx.reshape(-1)
    mine = flat_idx < e_loc
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
                      capacity: int, kind: str) -> torch.Tensor:
    """Dispatch, expert FFN and combine over the experts held here.

    xf: (t, d) tokens; idx/weights: (t, k) routing; wi/wg/wo: the experts
    (e_loc, ...).  Returns the (t, d) sum over them.
    """
    t, d = xf.shape
    e_loc = wi.shape[0]
    safe_e, safe_p, keep = dispatch(idx, e_loc, capacity)
    contrib = torch.where(keep[:, None], xf.repeat_interleave(k, dim=0), 0)
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

    gathered = out_buf.reshape(-1, d).index_select(0, rows)     # (t k, d)
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

    logits = xf @ params["router"].to(x.dtype)
    if epad:
        # padded experts: -1e30 logits, never selected, no flow
        logits = torch.cat([logits, logits.new_full((t, epad), -1e30)], -1)
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
