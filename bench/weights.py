"""Weights drawn from ``--seed``, in the port's state layout.

The benchmark makes the parameters itself and hands the same values to
the program (as its train state) and to the reference (drawn again after
the window).  The configuration's family module in ``reference/`` gives
the tree of shapes (``layout(model)``) and may name leaves that it draws
by a rule of its own (``DRAWS``, keyed by a leaf's last name, each rule
from ``MENU``).  Each leaf is one large draw on the device from a
generator of its own, seeded from the run's seed and the leaf's path, so
one leaf can be drawn again alone.  A leaf the family does not name is
0.02 N(0, 1), an output projection 0.02 / sqrt(2) N(0, 1), a norm scale
ones; all f32 (master weights).
"""
from __future__ import annotations

import math
from typing import Callable, Iterator, Mapping, Tuple

import torch

from bench import reference
from bench.traffic import mix

Shape = Tuple[int, ...]
F32 = torch.float32
DT_FLOOR = 1e-4


def _uniform(shape, gen, device, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=F32,
                      device=device).mul_(hi - lo).add_(lo)


def _dt_bias(shape, gen, device, lo: float, hi: float) -> torch.Tensor:
    """Mamba2's dt bias: dt log-uniform in [lo, hi], floored at 1e-4,
    through the inverse of softplus (dt + log(-expm1(-dt)))."""
    dt = _uniform(shape, gen, device, math.log(lo), math.log(hi))
    dt = dt.exp_().clamp_(min=DT_FLOOR)
    return dt + torch.log(-torch.expm1(-dt))


# the rules a family's ``DRAWS`` may name, as (rule, *arguments): each
# takes (shape, generator, device, *arguments)
MENU = {
    "ones": lambda shape, gen, device: torch.ones(shape, dtype=F32,
                                                  device=device),
    "zeros": lambda shape, gen, device: torch.zeros(shape, dtype=F32,
                                                    device=device),
    "constant": lambda shape, gen, device, value: torch.full(
        shape, float(value), dtype=F32, device=device),
    "normal": lambda shape, gen, device, std: torch.randn(
        shape, generator=gen, dtype=F32, device=device).mul_(std),
    "uniform": _uniform,
    "log_of_uniform": lambda shape, gen, device, lo, hi: _uniform(
        shape, gen, device, lo, hi).log_(),
    "dt_bias": _dt_bias,
}


def layout(config: dict) -> dict:
    """The parameter tree of a configuration (its file), as its family
    module gives it: nested dicts of shapes, ``None`` for an absent leaf,
    the layers stacked on axis 0 of each block leaf."""
    return reference.load(config).layout(config["model"])


def leaves(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(dotted path, leaf) in the tree's key order, ``None`` left out."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key, val in tree.items():
            yield from leaves(val, f"{prefix}{key}" if not prefix
                              else f"{prefix}.{key}")
        return
    yield prefix, tree


def tree_of(shapes, fill) -> dict:
    """``shapes``' tree with ``fill(path, shape)`` at each leaf."""
    def walk(t, prefix):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(val, f"{prefix}.{k}" if prefix else k)
                    for k, val in t.items()}
        return fill(prefix, t)
    return walk(shapes, "")


def draw(path: str, shape: Shape, seed: int, device,
         rules: Mapping[str, tuple]) -> torch.Tensor:
    """Leaf ``path`` of the parameters of run ``seed``, f32 on ``device``,
    by the rule ``rules`` gives its last name, or else the default."""
    rule = rules.get(path.rsplit(".", 1)[-1])
    if rule is None and path.endswith("scale"):
        return torch.ones(shape, dtype=F32, device=device)
    gen = torch.Generator(device=device).manual_seed(mix(seed, path))
    if rule is not None:
        return MENU[rule[0]](shape, gen, device, *rule[1:])
    w = torch.randn(shape, generator=gen, dtype=F32, device=device)
    scale = 0.02 / math.sqrt(2.0) if path.endswith("wo") else 0.02
    return w.mul_(scale)


def initial(config: dict, seed: int, device) -> Callable[[str], torch.Tensor]:
    """Each leaf of the configuration's parameters by its path, drawn
    alone from ``seed`` by its family module's ``DRAWS`` or the default."""
    rules = getattr(reference.load(config), "DRAWS", {})
    unknown = sorted({rule[0] for rule in rules.values()} - set(MENU))
    if unknown:
        raise ValueError(f"DRAWS names {unknown}; the menu has "
                         f"{sorted(MENU)}")
    shapes = dict(leaves(layout(config)))
    return lambda path: draw(path, shapes[path], seed, device, rules)


def train_state(config: dict, seed: int, device) -> dict:
    """The port's train state: f32 parameters from ``seed``, zero AdamW
    moments and count, step 0."""
    shapes, init = layout(config), initial(config, seed, device)

    def zeros(_path, shape):
        return torch.zeros(shape, dtype=F32, device=device)

    def count():
        return torch.zeros((), dtype=torch.int32, device=device)

    return {"params": tree_of(shapes, lambda path, _shape: init(path)),
            "opt": {"m": tree_of(shapes, zeros), "v": tree_of(shapes, zeros),
                    "count": count()},
            "step": count()}
