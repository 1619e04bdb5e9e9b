"""AdamW over parameter trees (port of ``repro.optim.adamw``).

One arithmetic, ``_adamw_update_into``, written into new tensors by
``adamw_update`` (JAX's function: its inputs are left as they were) or
into the state itself by ``adamw_update_``, the donated form (JAX's
``donate_argnums``: the gradients are consumed).  It sums the gradient
norm and updates on axis-0 slices of at most ``UPDATE_CHUNK`` elements, so
both forms give the same bits and hold a slice or two beside their
results.  JAX's AdamW is plain jnp, not a Pallas kernel; so is this.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.parallel.constraints import is_dtensor

# elements of a leaf the update takes at once (64 MiB of f32); a leaf is
# cut along axis 0 into slices of at most this many elements, or of one
# row (one layer of a stacked leaf) where a row is larger
UPDATE_CHUNK = 1 << 24
from repro_torch.utils.tree import tree_leaves, tree_map


def adamw_init(params: Any) -> Dict:
    """Zero f32 moments of the params' structure and a step count of 0."""
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def _row_slices(t: torch.Tensor):
    """Views of ``t`` along axis 0, each of at most ``UPDATE_CHUNK``
    elements or one row.  A DTensor is one slice: cutting a sharded axis
    would gather it, and its local shard is already one device's part."""
    if t.ndim == 0 or t.numel() <= UPDATE_CHUNK or is_dtensor(t):
        return [...]
    rows = max(1, UPDATE_CHUNK // max(1, t[0].numel()))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """``global_norm``'s term of one leaf, slice by slice: the same
    arithmetic where the leaf is one slice, a sum of f32 partial sums in
    another order where it is larger."""
    parts = [torch.sum(torch.square(g[rows].float()))
             for rows in _row_slices(g)]
    return parts[0] if len(parts) == 1 else sum(parts)


def _adamw_update_into(params: Any, grads: Any, opt_state: Dict, lr,
                       cfg: TrainConfig, new_params: Any,
                       new_opt: Dict) -> torch.Tensor:
    """One AdamW step from ``params``, ``grads`` and ``opt_state`` into
    ``new_params`` and ``new_opt``, trees of their structure: grads clipped
    by their pre-clip global norm, bias correction on the incremented
    count, weight decay on every leaf, the new params in their
    destinations' dtypes.  The destinations are either all the sources
    (``new_params is params`` and ``new_opt is opt_state``: updated in
    place, the gradients consumed as scratch) or all new tensors; a mix
    would consume the gradients of the leaves written in place and of
    those alone.  Returns the pre-clip norm, ``global_norm``'s to the bit
    where every leaf is one slice and within f32 rounding elsewhere
    (summed slice by slice)."""
    count = torch.add(opt_state["count"], 1, out=new_opt["count"])
    gnorm = torch.sqrt(sum(_square_sum(g) for g in tree_leaves(grads)))
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    bc1 = 1.0 - b1 ** count.float()
    bc2 = 1.0 - b2 ** count.float()

    def upd(p, g, m, v, new_p, new_m, new_v, in_place):
        g = g.mul_(clip) if in_place and g.dtype == torch.float32 \
            else g.float() * clip
        m = torch.mul(m, b1, out=new_m).add_(g, alpha=1 - b1)
        v = torch.mul(v, b2, out=new_v).addcmul_(g, g, value=1 - b2)
        # m / bc1 into the scaled gradient, spent from here: one temporary
        # slice, not two (a DTensor's gradient may be placed otherwise
        # than m: a new one)
        step = m / bc1 if is_dtensor(m) else torch.div(m, bc1, out=g)
        step.div_((v / bc2).sqrt_().add_(eps))
        pf = p.float()
        # rounded to new_p's dtype as it is stored
        torch.sub(pf, step.add_(pf, alpha=cfg.weight_decay).mul_(lr),
                  out=new_p)

    def leaf(p, g, m, v, new_p, new_m, new_v):
        for rows in _row_slices(p):
            upd(*(t[rows] for t in (p, g, m, v, new_p, new_m, new_v)),
                in_place=new_p is p)

    tree_map(leaf, params, grads, opt_state["m"], opt_state["v"],
             new_params, new_opt["m"], new_opt["v"])
    return gnorm


def adamw_update(params: Any, grads: Any, opt_state: Dict, lr,
                 cfg: TrainConfig) -> Tuple[Any, Dict]:
    """``_adamw_update_into`` new tensors (each param's dtype kept): returns
    (params, opt_state) and leaves ``params``, ``grads`` and ``opt_state``
    as they were."""
    new_params = tree_map(torch.empty_like, params)
    new_opt = tree_map(torch.empty_like, opt_state)
    _adamw_update_into(params, grads, opt_state, lr, cfg, new_params,
                       new_opt)
    return new_params, new_opt


def adamw_update_(params: Any, grads: Any, opt_state: Dict, lr,
                  cfg: TrainConfig) -> torch.Tensor:
    """``adamw_update`` in place: params, ``opt_state``'s m, v and count are
    written where they are, and ``grads`` is consumed.  Returns the
    gradients' pre-clip global norm (``_adamw_update_into``)."""
    return _adamw_update_into(params, grads, opt_state, lr, cfg, params,
                              opt_state)
