"""Spliced training step: the paper's replica splicing (port of
``repro.training.step``).

The logical world size W is constant; the scheduler maps W logical ranks
onto P physical devices (splice factor s = W/P).  One step:

- runs the s time-slices of the global batch in turn, each one resident
  logical-rank group's forward and backward (the context switch of §5.1);
- sums their gradients in f32, in slice order, then divides by s (the
  device proxy's local accumulation);
- runs the optimizer once, after the last slice: squashing (§5.2.3) holds
  by construction, as there is no per-slice update to omit.

JAX scans over the slices inside one jitted program; here they are a
Python loop, and the backward of each slice runs before the next slice's
forward, so only one slice's activations are live at a time.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.barrier_step import meta_allreduce
from repro_torch.models.model import check_trainable, model_forward
from repro_torch.optim.adamw import adamw_update, global_norm
from repro_torch.optim.schedule import lr_schedule
from repro_torch.utils.tree import tree_leaves, tree_unflatten


def loss_and_grads(params: Dict, batch: Dict, cfg: ModelConfig,
                   tcfg: TrainConfig, splice: int = 1
                   ) -> Tuple[torch.Tensor, Dict]:
    """The slices of one step: (loss, grads), the loss and the f32
    gradients each averaged over the ``splice`` slices of ``batch`` (whose
    leaves have the global batch as their leading axis)."""
    g = batch["tokens"].shape[0]
    if splice < 1 or g % splice:
        raise ValueError(f"global batch {g} does not split into {splice} "
                         f"slices")
    per = g // splice
    leaves = tree_leaves(params)
    lsum, acc = None, None
    for i in range(splice):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in leaves]
            loss, _ = model_forward(tree_unflatten(params, xs), mb, cfg,
                                    remat=tcfg.remat,
                                    remat_policy=tcfg.remat_policy)
            grads = torch.autograd.grad(loss, xs)
        grads = [gr.float() for gr in grads]
        if acc is None:
            lsum, acc = loss.detach(), grads
        else:
            lsum = lsum + loss.detach()
            for a, gr in zip(acc, grads):
                a.add_(gr)
    if splice > 1:
        for a in acc:
            a.div_(splice)
    return lsum / splice, tree_unflatten(params, acc)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, splice: int = 1,
                     with_barrier: bool = False) -> Callable:
    """Returns train_step(state, batch[, barrier_flags]) -> (state, metrics).

    Metrics: ``loss``, ``lr``, ``grad_norm`` and, ``with_barrier``, the
    summed (need, ack) ``barrier`` payload.  The returned state holds new
    tensors; the one passed in is left as it was.
    """
    check_trainable(cfg)

    def train_step(state: Dict, batch: Dict, barrier_flags=None):
        loss, grads = loss_and_grads(state["params"], batch, cfg, tcfg,
                                     splice)
        lr = lr_schedule(state["step"], tcfg)
        new_params, new_opt = adamw_update(state["params"], grads,
                                           state["opt"], lr, tcfg)
        metrics = {"loss": loss, "lr": lr, "grad_norm": global_norm(grads)}
        if with_barrier:
            if barrier_flags is None:
                raise ValueError("a step with the barrier needs its flags")
            metrics["barrier"] = meta_allreduce(barrier_flags)
        return ({"params": new_params, "opt": new_opt,
                 "step": state["step"] + 1}, metrics)

    return train_step
