"""AdamW over parameter trees (port of ``repro.optim.adamw``).

The update makes new tensors for the parameters and both moments, as the
JAX function returns new arrays; its intermediates are updated in place,
one leaf at a time, so the transient memory is a few copies of the largest
leaf.  JAX's AdamW is plain jnp, not a Pallas kernel; so is this.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import TrainConfig
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
