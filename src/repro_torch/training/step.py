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

Each slice's backward adds into one f32 gradient sum as it goes
(``.grad``; a stacked leaf's layers add into it one by one, ``models/
model._unstack``).  ``donate=True`` is JAX's ``donate_argnums`` on the
state: the step writes the parameters, moments, count and step in place
and consumes the state passed in, and the update frees the gradient sum
before the step returns; without it they go into new tensors.  Both run
one update, ``optim/adamw.py::_adamw_update_into``.  So a donated step
holds 16 bytes a parameter (f32 params, m, v and the gradient sum) beside
one layer's gradient and the activations, where the functional one holds
28 at its update, the old state and the new (granite-moe-3b-a800m at 32
layers, batch 4 x 4096 at splice 1, donated, on an H100 80GB: a peak of
54.368 GiB in the benchmark's granite-moe-train-s1 cell).  Under
a mesh (``parallel/constraints.use_mesh``) the same step runs on DTensor
params and batch.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.barrier_step import meta_allreduce
from repro_torch.parallel.constraints import current_mesh
from repro_torch.models.model import check_trainable, model_forward
from repro_torch.optim.adamw import _adamw_update_into
from repro_torch.optim.schedule import lr_schedule
from repro_torch.utils.spans import span
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def loss_and_grads(params: Dict, batch: Dict, cfg: ModelConfig,
                   tcfg: TrainConfig, splice: int = 1
                   ) -> Tuple[torch.Tensor, Dict]:
    """The slices of one step: (loss, grads), the loss and the f32
    gradients each averaged over the ``splice`` slices of ``batch`` (whose
    leaves have the global batch as their leading axis).  ``params`` are a
    train state's f32 leaves, which are left as they are.

    Each slice's backward adds its gradients into one sum leaf by leaf
    (``.grad``, in slice order), so one set of gradients is live."""
    g = batch["tokens"].shape[0]
    if splice < 1 or g % splice:
        raise ValueError(f"global batch {g} does not split into {splice} "
                         f"slices")
    per = g // splice
    xs = [t.detach().requires_grad_() for t in tree_leaves(params)]
    tree = tree_unflatten(params, xs)
    lsum = None
    for i in range(splice):
        mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
        with torch.enable_grad():
            with span("step.forward"):
                loss, _ = model_forward(tree, mb, cfg, remat=tcfg.remat,
                                        remat_policy=tcfg.remat_policy)
            with span("step.backward"):
                torch.autograd.backward(loss, inputs=xs)
        lsum = loss.detach() if lsum is None else lsum + loss.detach()
    acc = []
    with span("step.grad_sum"):
        for x in xs:
            gr, x.grad = x.grad, None
            acc.append(gr.div_(splice) if splice > 1 else gr)
    return lsum / splice, tree_unflatten(params, acc)


def build_train_step(cfg: ModelConfig, tcfg: TrainConfig, splice: int = 1,
                     with_barrier: bool = False, donate: bool = False
                     ) -> Callable:
    """Returns train_step(state, batch[, barrier_flags]) -> (state, metrics).

    Metrics: ``loss``, ``lr``, ``grad_norm`` and, ``with_barrier``, the
    summed (need, ack) ``barrier`` payload (over the mesh's data axes under
    a mesh).  The returned state holds new tensors and the one passed in is
    left as it was; with ``donate`` the state passed in is updated in place
    and returned, and any earlier reference to its tensors sees the update.
    """
    check_trainable(cfg)

    def train_step(state: Dict, batch: Dict, barrier_flags=None):
        loss, grads = loss_and_grads(state["params"], batch, cfg, tcfg,
                                     splice)
        with span("step.update"):
            lr = lr_schedule(state["step"], tcfg)
            new_state = state if donate else tree_map(torch.empty_like,
                                                      state)
            gnorm = _adamw_update_into(state["params"], grads, state["opt"],
                                       lr, tcfg, new_state["params"],
                                       new_state["opt"])
            del grads
            torch.add(state["step"], 1, out=new_state["step"])
        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        if with_barrier:
            if barrier_flags is None:
                raise ValueError("a step with the barrier needs its flags")
            metrics["barrier"] = meta_allreduce(barrier_flags,
                                                current_mesh())
        return new_state, metrics

    return train_step
