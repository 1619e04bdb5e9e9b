"""AdamW over parameter trees (port of ``repro.optim.adamw``).

``adamw_update`` makes new tensors for the parameters and both moments, as
the JAX function returns new arrays; its intermediates are updated in
place, one leaf at a time, so the transient memory is a few copies of the
largest leaf.  ``adamw_update_`` is the donated form (JAX's
``donate_argnums`` on the state): it writes the parameters and moments in
place and consumes the gradients, in the same arithmetic order, so its
results equal ``adamw_update``'s to the bit (its docstring says where the
gradient norm is summed in another order); it works on axis-0 slices of
at most ``UPDATE_CHUNK`` elements (one layer of a stacked leaf at least),
so its transient memory is one such slice.  JAX's AdamW is plain jnp, not
a Pallas kernel; so is this.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.parallel.constraints import is_dtensor

# elements of a leaf the in-place update takes at once (64 MiB of f32); a
# leaf is cut along axis 0 into slices of at most this many elements, or
# of one row (one layer of a stacked leaf) where a row is larger
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


def adamw_update(params: Any, grads: Any, opt_state: Dict, lr,
                 cfg: TrainConfig) -> Tuple[Any, Dict]:
    """One AdamW step: grads clipped by their pre-clip global norm, bias
    correction on the incremented count, weight decay on every leaf, new
    params cast back to each param's dtype.  Returns (params, opt_state)."""
    count = opt_state["count"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    bc1 = 1.0 - b1 ** count.float()
    bc2 = 1.0 - b2 ** count.float()

    def upd(p, g, m, v):
        g = g.float() * clip
        m = (m * b1).add_(g, alpha=1 - b1)
        v = (v * b2).addcmul_(g, g, value=1 - b2)
        step = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
        pf = p.float()
        new_p = pf - step.add_(pf, alpha=cfg.weight_decay).mul_(lr)
        return new_p.to(p.dtype), m, v

    new = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return (tree_map(lambda t: t[0], new),
            {"m": tree_map(lambda t: t[1], new),
             "v": tree_map(lambda t: t[2], new), "count": count})


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


def adamw_update_(params: Any, grads: Any, opt_state: Dict, lr,
                  cfg: TrainConfig) -> torch.Tensor:
    """``adamw_update`` in place: params, ``opt_state``'s m, v and count are
    written where they are, and ``grads`` is consumed (scaled by the clip in
    place).  Returns the gradients' pre-clip global norm, which is
    ``global_norm``'s to the bit where every leaf is one slice (every
    leaf of at most ``UPDATE_CHUNK`` elements) and within f32 rounding
    elsewhere: a leaf's squares are summed slice by slice, so that no
    temporary is larger than a slice."""
    count = opt_state["count"].add_(1)
    gnorm = torch.sqrt(sum(_square_sum(g) for g in tree_leaves(grads)))
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1, b2, eps = cfg.beta1, cfg.beta2, cfg.eps
    bc1 = 1.0 - b1 ** count.float()
    bc2 = 1.0 - b2 ** count.float()

    def upd(p, g, m, v):
        g = g.mul_(clip) if g.dtype == torch.float32 else g.float() * clip
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        # m / bc1 into the spent gradient: one temporary slice, not two (a
        # DTensor's gradient may be placed otherwise than m: a new one)
        step = m / bc1 if is_dtensor(m) else torch.div(m, bc1, out=g)
        step.div_((v / bc2).sqrt_().add_(eps))
        if p.dtype == torch.float32:
            p.sub_(step.add_(p, alpha=cfg.weight_decay).mul_(lr))
        else:
            pf = p.float()
            p.copy_(pf - step.add_(pf, alpha=cfg.weight_decay).mul_(lr))

    def leaf(p, g, m, v):
        for rows in _row_slices(p):
            upd(p[rows], g[rows], m[rows], v[rows])

    tree_map(leaf, params, grads, opt_state["m"], opt_state["v"])
    return gnorm
