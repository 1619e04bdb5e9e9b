"""Weights drawn from ``--seed``, in the port's state layout.

The benchmark makes the parameters itself and hands the same values to
the program (as its train state) and to the reference (drawn again after
the window).  Each leaf is one large draw on the device from a generator
of its own, seeded from the run's seed and the leaf's path, so one leaf
can be drawn again alone.  Matrices are 0.02 N(0, 1), output projections
0.02 / sqrt(2) N(0, 1), norm scales ones; all f32 (master weights).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple

import torch

from bench.traffic import mix

Shape = Tuple[int, ...]


def _norm(model: dict, *lead: int) -> Optional[Dict[str, Shape]]:
    if model["norm"] == "nonparametric_ln":
        return None
    if model["norm"] == "rmsnorm":
        return {"scale": (*lead, model["d_model"])}
    raise ValueError(f"norm {model['norm']!r}: the benchmark draws "
                     f"nonparametric_ln and rmsnorm")


def layout(model: dict) -> dict:
    """The parameter tree of a dense or MoE transformer as the port holds
    it: nested dicts of shapes, ``None`` for an absent norm, the layers
    stacked on axis 0 of each block leaf."""
    if model["arch_type"] not in ("dense", "moe"):
        raise ValueError(f"arch_type {model['arch_type']!r}: the benchmark "
                         f"draws dense and moe transformers")
    d, v, n = model["d_model"], model["vocab_size"], model["num_layers"]
    h, kvh, ff = model["num_heads"], model["num_kv_heads"], model["d_ff"]
    hd = model.get("head_dim") or d // h
    tree = {"embed": (v, d), "final_norm": _norm(model)}
    if not model.get("tie_embeddings"):
        tree["head"] = (d, v)
    blocks = {"ln1": _norm(model, n),
              "attn": {"wq": (n, d, h, hd), "wk": (n, d, kvh, hd),
                       "wv": (n, d, kvh, hd), "wo": (n, h, hd, d)},
              "ln2": _norm(model, n)}
    if model["arch_type"] == "moe":
        e = model["moe"]["num_experts"]
        blocks["moe"] = {"router": (n, d, e), "wi": (n, e, d, ff),
                         "wo": (n, e, ff, d), "wg": (n, e, d, ff)}
    else:
        blocks["mlp"] = {"wi": (n, d, ff), "wg": (n, d, ff),
                         "wo": (n, ff, d)}
    tree["blocks"] = blocks
    return tree


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


def draw(path: str, shape: Shape, seed: int, device) -> torch.Tensor:
    """Leaf ``path`` of the parameters of run ``seed``, f32 on ``device``."""
    if path.endswith("scale"):
        return torch.ones(shape, dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(mix(seed, path))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    scale = 0.02 / math.sqrt(2.0) if path.endswith("wo") else 0.02
    return w.mul_(scale)


def train_state(model: dict, seed: int, device) -> dict:
    """The port's train state: f32 parameters from ``seed``, zero AdamW
    moments and count, step 0."""
    shapes = layout(model)

    def zeros(_path, shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def count():
        return torch.zeros((), dtype=torch.int32, device=device)

    return {"params": tree_of(shapes, lambda path, s: draw(path, s, seed,
                                                           device)),
            "opt": {"m": tree_of(shapes, zeros), "v": tree_of(shapes, zeros),
                    "count": count()},
            "step": count()}
