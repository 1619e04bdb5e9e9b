"""Move parameter trees between the JAX package and the port.

The JAX package's ``init_params`` returns a nested dict of arrays with the
layers stacked on axis 0 (``blocks/attn/wq`` is (L, d, H, hd)) and ``None``
for absent norm parameters (olmo's ``ln1``, ``ln2`` and ``final_norm``).
A train state (``repro.training.state``) is that tree under ``params``, the
AdamW moments of its structure under ``opt/m`` and ``opt/v``, the AdamW
``opt/count`` and the ``step``.
The port keeps the same tree: the same keys in the same order, the same
``None`` leaves, the same shapes, with tensors for arrays.  Numpy sits in
between, so this module imports neither JAX nor anything of ``repro``:
the caller turns the JAX tree into numpy first
(``jax.tree_util.tree_map(np.asarray, params)``).  The checkpoint store
(``core/checkpoint.py``) holds the same numpy trees: a snapshot leaves the
runtime through ``train_state_to_numpy`` and a restored one comes back
through ``train_state_from_jax``, whichever package wrote it.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import F32_LEAVES, check_ported


def _to_tensor(arr, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: widen, exactly
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())  # JAX's arrays are read-only
    return t.to(device=device, dtype=dtype or t.dtype)


def _map(tree: Any, fn, key: str = "") -> Any:
    """``fn(leaf, key)`` over the tree, ``key`` the leaf's own name."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(val, fn, k) for k, val in tree.items()}
    return fn(tree, key)


def params_from_jax(tree: dict, cfg: ModelConfig, device="cpu",
                    dtype: Optional[torch.dtype] = None) -> dict:
    """The port's parameter tree from a JAX tree of numpy arrays.

    Values are copied bit for bit; ``dtype``, when given, casts every leaf
    but the SSM's ``A_log``, ``D`` and ``dt_bias`` and the cross-attention
    gates, which JAX keeps and uses in f32 (the port may store its weights
    once in the compute dtype, where the JAX engine keeps f32 and casts at
    every use: the values used are the same).
    """
    check_ported(cfg)
    embed = tree["embed"]
    if tuple(embed.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed shape {tuple(embed.shape)} does not match "
                         f"{cfg.name} ({cfg.vocab_size}, {cfg.d_model})")
    return _map(tree, lambda a, key: _to_tensor(
        a, device, None if key in F32_LEAVES else dtype))


def params_to_numpy(params: dict) -> dict:
    """The port's tree as numpy arrays, keys, order and ``None`` kept.

    numpy has no bfloat16, so bf16 tensors come back as float32, which
    holds every bf16 value exactly.
    """
    def leaf(t: torch.Tensor, _key: str) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _map(params, leaf)


def train_state_from_jax(tree: dict, cfg: ModelConfig, device="cpu") -> dict:
    """The port's train state from a JAX train state of numpy arrays:
    params, ``opt`` (``m``, ``v``, ``count``) and ``step``, bit for bit,
    with the same keys, order and ``None`` leaves."""
    if set(tree) != {"params", "opt", "step"}:
        raise ValueError(f"a train state has params, opt and step; got "
                         f"{sorted(tree)}")
    def same(t):
        return _map(t, lambda a, _key: _to_tensor(a, device, None))

    return {key: params_from_jax(val, cfg, device) if key == "params"
            else same(val) for key, val in tree.items()}


def train_state_to_numpy(state: dict) -> dict:
    """The port's train state as numpy arrays (see ``params_to_numpy``)."""
    return params_to_numpy(state)
