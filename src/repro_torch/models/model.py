"""Model assembly: serving and training for the dense, MoE, SSM, hybrid,
audio (encoder-decoder) and VLM families (port of ``repro.models.model``),
and training for the interleaved family, which the JAX package has not.

- ``init_params``       — parameter tree, layers stacked on axis 0 as in JAX
- ``model_forward``     — training forward -> (loss, metrics)
- ``prefill_fn``        — prompt processing -> (last logits, decode state)
- ``decode_step_fn``    — one-token decode with the KV and SSM caches
- ``init_decode_state`` — cache allocation

Parameters are nested dicts of tensors in the JAX tree's layout and key
order (``bridge.py`` converts between the two), with ``None`` for absent
norm parameters.  Layers run as a Python loop over views of the stacked
weights, where JAX scans; the hybrid family (zamba2) walks the same group
layout as JAX's group scans: ``n_groups`` groups of ``attn_every`` Mamba2
layers, each followed by the one shared attention block, then the tail
layers; the VLM family (llama-3.2-vision) groups of ``cross_attn_every``
dense layers, each followed by its gated cross-attention block over the
projected image embeddings.  The audio family (whisper) runs its
bidirectional encoder over the frame embeddings once, then decoder layers
of self-attention, gated cross attention over the encoder's output and
MLP.  The cross-attention gates are f32 scalars, zero at init, whatever
the parameters' dtype.

The interleaved family (granite-4.0-h, ``granitemoehybrid``) runs its
layers in the order of ``layer_types``: each layer is a mixer, a Mamba2
block or GQA self-attention, then its own SwiGLU MLP, both with pre-norms
and residual branches scaled by ``residual_multiplier``.  Its parameters
hold one stack a kind of layer: ``blocks`` the Mamba2 layers (``ln1``,
``ssm``, ``ln2``, ``mlp``), ``attn_blocks`` the attention layers (``ln1``,
``attn``, ``ln2``, ``mlp``).  Granite's multipliers (``ModelConfig``'s
``embedding_multiplier``, ``attention_multiplier``,
``residual_multiplier``, ``logits_scaling``) apply in the training forward
of the MoE and interleaved families (``MULTIPLIED``); the others refuse
them, as serving does.  At its default each one launches nothing.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.fused_ce import fused_cross_entropy
from repro_torch.kernels.fused_ce.ops import fused_ce_shard_stats
from repro_torch.models import attention as attn_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import apply_norm, dense_init, norm_param
from repro_torch.parallel.constraints import (BATCH, MODEL, clean_spec,
                                              constrain, current_mesh,
                                              is_dtensor, local_size,
                                              mesh_axis_sizes, pin,
                                              shard_map)
from repro_torch.utils import torch_dtype
from repro_torch.utils.spans import span

PORTED = ("dense", "moe", "ssm", "hybrid", "audio", "vlm", "interleaved")
# families that train but are not served (no prefill or decode yet)
NOT_SERVED = ("interleaved",)
# families whose training forward takes granite's multipliers: granite-4.0-h
# and granite-moe
MULTIPLIED = ("moe", "interleaved")
LAYER_KINDS = ("mamba", "attention")
# leaves kept in f32 whatever the parameters' dtype, as in JAX: the SSM's
# A_log, D and dt_bias, and the cross-attention gates
F32_LEAVES = ssm_lib.F32_LEAVES + ("gate",)


def _multiplied(cfg: ModelConfig) -> bool:
    """Whether any of granite's multipliers is off its default."""
    return (cfg.embedding_multiplier != 1.0 or cfg.attention_multiplier != 0.0
            or cfg.residual_multiplier != 1.0 or cfg.logits_scaling != 1.0)


def check_ported(cfg: ModelConfig, serving: bool = False) -> None:
    """The family is the port's; with ``serving``, one that prefill and
    decode run: not the interleaved family, and no granite multiplier off
    its default (the serving paths do not apply them)."""
    if cfg.arch_type not in PORTED:
        raise ValueError(f"{cfg.name}: unknown arch_type {cfg.arch_type!r}; "
                         f"the families are {PORTED}")
    if cfg.arch_type == "interleaved":
        layer_counts(cfg)
    if serving and cfg.arch_type in NOT_SERVED:
        raise ValueError(f"{cfg.name}: the {cfg.arch_type} family trains "
                         f"but is not served (no prefill or decode)")
    if serving and _multiplied(cfg):
        raise ValueError(f"{cfg.name}: serving does not apply the "
                         f"embedding, attention, residual or logit "
                         f"multipliers")


def layer_counts(cfg: ModelConfig) -> Tuple[int, int]:
    """(Mamba2 layers, attention layers) of the interleaved family, from
    ``layer_types``."""
    kinds = cfg.layer_types
    if len(kinds) != cfg.num_layers or not set(kinds) <= set(LAYER_KINDS):
        raise ValueError(f"{cfg.name}: layer_types must give each of the "
                         f"{cfg.num_layers} layers one of {LAYER_KINDS}; "
                         f"got {kinds}")
    return kinds.count("mamba"), kinds.count("attention")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_attn_block(cfg: ModelConfig, gen: torch.Generator, device,
                     dtype) -> Dict:
    hd = cfg.resolved_head_dim()
    return {
        "ln1": norm_param(cfg.norm, cfg.d_model, device=device, dtype=dtype),
        "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.num_heads,
                                        cfg.num_kv_heads, hd, device=device,
                                        dtype=dtype),
        "ln2": norm_param(cfg.norm, cfg.d_model, device=device, dtype=dtype),
        "mlp": mlp_lib.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                                device=device, dtype=dtype),
    }


def _init_moe_block(cfg: ModelConfig, gen: torch.Generator, device,
                    dtype) -> Dict:
    block = _init_attn_block(cfg, gen, device, dtype)
    del block["mlp"]
    block["moe"] = moe_lib.init_moe(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                                    cfg.moe, device=device, dtype=dtype)
    return block


def _init_ssm_block(cfg: ModelConfig, gen: torch.Generator, device,
                    dtype) -> Dict:
    return {
        "ln1": norm_param(cfg.norm, cfg.d_model, device=device, dtype=dtype),
        "ssm": ssm_lib.init_ssm(gen, cfg.d_model, cfg.ssm, device=device,
                                dtype=dtype),
    }


def _init_mamba_layer(cfg: ModelConfig, gen: torch.Generator, device,
                      dtype) -> Dict:
    """A Mamba2 layer of the interleaved family: the Mamba2 block, then
    its MLP with its norm."""
    return {
        **_init_ssm_block(cfg, gen, device, dtype),
        "ln2": norm_param(cfg.norm, cfg.d_model, device=device, dtype=dtype),
        "mlp": mlp_lib.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp,
                                device=device, dtype=dtype),
    }


def _init_cross_block(cfg: ModelConfig, gen: torch.Generator, device,
                      dtype) -> Dict:
    hd = cfg.resolved_head_dim()
    return {
        "ln": norm_param(cfg.norm, cfg.d_model, device=device, dtype=dtype),
        "attn": attn_lib.init_attention(gen, cfg.d_model, cfg.num_heads,
                                        cfg.num_kv_heads, hd, device=device,
                                        dtype=dtype),
        # zero-init cross-attention gate, f32 whatever ``dtype``
        "gate": torch.zeros((), device=device, dtype=torch.float32),
    }


def _stack(trees):
    """Stack a list of equal trees leaf by leaf on a new axis 0."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {key: _stack([t[key] for t in trees]) for key in first}
    return torch.stack(trees)


def _unstack(tree, n: int) -> "_Layers":
    """The ``n`` layers of a stacked tree, as views, each made when it is
    taken (``layers[i]``, a slice of them, or in turn by iterating).

    Not ``tree[i]`` per layer: under autograd the gradient of an indexed
    layer is a zero tensor of the whole stack, so a training step would
    fill and add L full-size f32 stacks per leaf.  Nor one ``torch.unbind``
    before the layers run: autograd runs a node after every node made
    later, so its backward waits for the last layer's and holds all L
    layer gradients until then.  Under autograd each layer is a
    ``_LayerOf`` view made just before its layer runs, whose backward then
    runs right after the layer's and adds its gradient into one stack
    (``_GradSum``)."""
    if tree is None:
        return _Layers(lambda i: None, n)
    if isinstance(tree, dict):
        per_key = {key: _unstack(val, n) for key, val in tree.items()}
        return _Layers(lambda i: {key: layers[i]
                                  for key, layers in per_key.items()}, n)
    if is_dtensor(tree):
        # a 1-D stacked leaf (the cross gates) may be split over its layer
        # axis; DTensor has no unbind of a split dim: gather it (L scalars)
        tree = constrain(tree, *(None,) * tree.ndim) if tree.ndim == 1 \
            else tree
    if torch.is_grad_enabled() and tree.requires_grad:
        box = _GradSum(tree)
        whole = _StackOf.apply(tree, box)
        return _Layers(lambda i: _LayerOf.apply(whole, i, box), n)
    return _Layers(tree.unbind(0).__getitem__, n)


class _Layers:
    """A stack's layers, each made by ``take(i)`` when it is taken."""

    def __init__(self, take, n: int):
        self._take, self._n = take, n

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._take(j) for j in range(*i.indices(self._n))]
        if not -self._n <= i < self._n:
            raise IndexError(i)
        return self._take(i % self._n)

    def __iter__(self):
        return (self._take(i) for i in range(self._n))


class _GradSum:
    """The gradient of one stacked tensor, summed layer by layer: into the
    tensor's own ``.grad`` when it is a leaf that has one (a later slice
    of a spliced step, which accumulates there), else into a zero stack
    made at the first layer's backward and handed to autograd by
    ``_StackOf``'s backward, after every layer's (the first slice's then
    becomes the leaf's ``.grad`` without a copy).  Each layer's gradient
    is freed as soon as it is added; the additions are those of unbind's
    stack and ``.grad``'s accumulation, so the sums are the same bits."""

    def __init__(self, tree: torch.Tensor):
        self.tree, self.stack = tree, None

    def add(self, i: int, grad: torch.Tensor) -> None:
        with span("step.grad_sum"):
            tree = self.tree
            if tree.is_leaf and tree.grad is not None:
                target = tree.grad
            else:
                if self.stack is None:
                    self.stack = torch.zeros_like(tree)
                target = self.stack
            layer = target[i]
            if is_dtensor(layer):  # a partial sum is reduced to the sum's split
                grad = grad.redistribute(layer.device_mesh, layer.placements)
            layer.add_(grad)


class _StackOf(torch.autograd.Function):
    """The stacked tensor as it is; its backward runs after every
    ``_LayerOf`` taken from it and returns their sum (None once it went
    into ``.grad``)."""

    @staticmethod
    def forward(ctx, tree, box):
        ctx.box = box
        ctx.set_materialize_grads(False)
        return tree.view_as(tree)

    @staticmethod
    def backward(ctx, _grad):
        stack, ctx.box.stack = ctx.box.stack, None
        return stack, None


class _LayerOf(torch.autograd.Function):
    """Layer ``i`` of the stack, a view; its backward adds the layer's
    gradient into the sum and passes nothing on."""

    @staticmethod
    def forward(ctx, whole, i, box):
        ctx.i, ctx.box = i, box
        return whole[i]

    @staticmethod
    def backward(ctx, grad):
        if grad is not None:
            ctx.box.add(ctx.i, grad)
        return None, None, None


def group_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_groups, layers_per_group, tail_layers) for group-scan archs."""
    if cfg.arch_type == "hybrid":
        every = cfg.attn_every
    elif cfg.arch_type == "vlm":
        every = cfg.vlm.cross_attn_every
    else:
        return (0, 0, cfg.num_layers)
    n = cfg.num_layers // every
    return (n, every, cfg.num_layers - n * every)


def num_shared_attn(cfg: ModelConfig) -> int:
    return group_layout(cfg)[0] if cfg.arch_type == "hybrid" else 0


def num_cross_layers(cfg: ModelConfig) -> int:
    return group_layout(cfg)[0] if cfg.arch_type == "vlm" else 0


def _layers(cfg: ModelConfig, params: Dict):
    """(kind, block, cache index) for each block in the order JAX's (group)
    scans run them: ("attn", layer, i) for dense, MoE and VLM layer i (its
    feed-forward is the MLP or the expert layer); ("ssm", layer, i) for
    Mamba2 layer i; for hybrid, ("attn", shared block, g) after the layers
    of group g, then the tail layers; for VLM, ("cross", cross block g, g)
    after the layers of group g; for audio, ("audio", (layer, its cross
    block), i)."""
    blocks = _unstack(params["blocks"], cfg.num_layers)
    if cfg.arch_type in ("dense", "moe"):
        for i in range(cfg.num_layers):
            yield "attn", blocks[i], i
        return
    if cfg.arch_type == "audio":
        cross = _unstack(params["cross"], cfg.num_layers)
        for i in range(cfg.num_layers):
            yield "audio", (blocks[i], cross[i]), i
        return
    n, per, _ = group_layout(cfg)
    if cfg.arch_type == "vlm":
        kind, after = "attn", [("cross", c)
                               for c in _unstack(params["cross"], n)]
    else:
        kind, after = "ssm", [("attn", params.get("shared_attn"))] * n
    for g in range(n):
        for i in range(g * per, (g + 1) * per):
            yield kind, blocks[i], i
        yield (*after[g], g)
    for i in range(n * per, cfg.num_layers):
        yield "ssm", blocks[i], i


def init_params(cfg: ModelConfig, seed: int = 0, *, device,
                dtype=torch.float32) -> Dict:
    """Random weights from ``seed`` (a ``torch.Generator`` on ``device``).

    The same shapes, scales and tree as ``repro.models.init_params``; the
    values differ, since the two frameworks draw other random numbers.
    ``F32_LEAVES`` stay f32 whatever ``dtype``, as in JAX.  On the
    ``meta`` device it allocates nothing (the dry-run's abstract state).
    """
    check_ported(cfg)
    # a meta tensor draws nothing: a CPU generator stands in for it
    gen_device = "cpu" if torch.device(device).type == "meta" else device
    gen = torch.Generator(device=gen_device).manual_seed(seed)
    params: Dict = {
        "embed": dense_init(gen, (cfg.vocab_size, cfg.d_model), device=device,
                            dtype=dtype),
        "final_norm": norm_param(cfg.norm, cfg.d_model, device=device,
                                 dtype=dtype),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                    device=device, dtype=dtype)
    block = {"moe": _init_moe_block, "ssm": _init_ssm_block,
             "hybrid": _init_ssm_block}.get(cfg.arch_type, _init_attn_block)

    def stack(fn, n):
        return _stack([fn(cfg, gen, device, dtype) for _ in range(n)])

    if cfg.arch_type == "interleaved":
        n_mamba, n_attn = layer_counts(cfg)
        params["blocks"] = stack(_init_mamba_layer, n_mamba)
        params["attn_blocks"] = stack(_init_attn_block, n_attn)
        return params
    params["blocks"] = stack(block, cfg.num_layers)
    if cfg.arch_type == "hybrid":
        # zamba2: ONE shared attention block applied every attn_every layers
        params["shared_attn"] = _init_attn_block(cfg, gen, device, dtype)
    if cfg.arch_type == "vlm":
        params["cross"] = stack(_init_cross_block, num_cross_layers(cfg))
        params["projector"] = dense_init(
            gen, (cfg.vlm.image_embed_dim, cfg.d_model), device=device,
            dtype=dtype)
    if cfg.arch_type == "audio":
        params["encoder"] = {
            "blocks": stack(_init_attn_block, cfg.encdec.encoder_layers),
            "final_norm": norm_param(cfg.norm, cfg.d_model, device=device,
                                     dtype=dtype),
        }
        params["cross"] = stack(_init_cross_block, cfg.num_layers)
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

def _norm(cfg: ModelConfig, x: torch.Tensor, params: Optional[dict]
          ) -> torch.Tensor:
    return apply_norm(cfg.norm, x, params, cfg.norm_eps)


def _residual(cfg: ModelConfig, x: torch.Tensor, h: torch.Tensor
              ) -> torch.Tensor:
    """x + residual_multiplier * h (no product at the default 1)."""
    if cfg.residual_multiplier != 1.0:
        h = h * cfg.residual_multiplier
    return x + h


def _self_attn(cfg: ModelConfig, block: Dict, x: torch.Tensor
               ) -> torch.Tensor:
    h = _norm(cfg, x, block["ln1"])
    h = attn_lib.attention_forward(
        block["attn"], h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta,
        window=cfg.sliding_window, softmax_scale=cfg.attention_multiplier)
    return _residual(cfg, x, h)


def _mlp_res(cfg: ModelConfig, block: Dict, x: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, x, block["ln2"])
    return _residual(cfg, x, mlp_lib.mlp_forward(block["mlp"], h, cfg.mlp))


def _moe_res(cfg: ModelConfig, block: Dict, x: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert layer's residual and its weighted aux loss."""
    h = _norm(cfg, x, block["ln2"])
    out, aux = moe_lib.moe_forward(block["moe"], h, cfg.mlp, cfg.moe)
    return _residual(cfg, x, out), aux


def _ffn_res(cfg: ModelConfig, block: Dict, x: torch.Tensor) -> torch.Tensor:
    """The block's feed-forward residual: its MLP, or its expert layer
    (whose aux loss serving drops, as JAX's prefill and decode do)."""
    if "moe" in block:
        return _moe_res(cfg, block, x)[0]
    return _mlp_res(cfg, block, x)


def _dense_block(cfg: ModelConfig, block: Dict, x: torch.Tensor
                 ) -> torch.Tensor:
    return _mlp_res(cfg, block, _self_attn(cfg, block, x))


def _moe_block(cfg: ModelConfig, block: Dict, x: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _moe_res(cfg, block, _self_attn(cfg, block, x))


def _ssm_block(cfg: ModelConfig, block: Dict, x: torch.Tensor) -> torch.Tensor:
    h = _norm(cfg, x, block["ln1"])
    return _residual(cfg, x, ssm_lib.ssm_forward(block["ssm"], h, cfg.ssm,
                                                 cfg.norm_eps))


def _interleaved_layer(cfg: ModelConfig, layer, x: torch.Tensor
                       ) -> torch.Tensor:
    """One layer of the interleaved family: its mixer, the Mamba2 block or
    self-attention, then its MLP.  ``layer`` is (kind, its weights)."""
    kind, block = layer
    mix = _ssm_block if kind == "mamba" else _self_attn
    return _mlp_res(cfg, block, mix(cfg, block, x))


def _cross_block(cfg: ModelConfig, cblock: Dict, x: torch.Tensor,
                 kv_src: torch.Tensor) -> torch.Tensor:
    """x + tanh(gate) * cross attention over ``kv_src`` (no RoPE; GQA
    through ``_repeat_kv``)."""
    h = _norm(cfg, x, cblock["ln"])
    h = attn_lib.attention_forward(
        cblock["attn"], h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, rope_theta=0.0, kv=kv_src,
        causal=False)
    return x + torch.tanh(cblock["gate"]).to(x.dtype) * h


def _audio_block(cfg: ModelConfig, blocks, x: torch.Tensor,
                 cross_src: torch.Tensor) -> torch.Tensor:
    """A decoder layer of the audio family: causal self-attention (no
    window), gated cross attention over the encoder's output, MLP.
    ``blocks`` is (the layer, its cross block)."""
    block, cross = blocks
    h = _norm(cfg, x, block["ln1"])
    h = attn_lib.attention_forward(
        block["attn"], h, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, rope_theta=cfg.rope_theta)
    x = _cross_block(cfg, cross, x + h, cross_src)
    return _mlp_res(cfg, block, x)


def _vlm_group(cfg: ModelConfig, group, x: torch.Tensor,
               cross_src: torch.Tensor) -> torch.Tensor:
    """One group of the VLM family: its dense layers, then its cross block
    over the projected image embeddings (JAX's ``group`` step of the VLM
    scan).  ``group`` is (the group's layers, the cross block)."""
    blocks, cross = group
    for block in blocks:
        x = _dense_block(cfg, block, x)
    return _cross_block(cfg, cross, x, cross_src)


def _encoder_forward(cfg: ModelConfig, params: Dict, frames: torch.Tensor
                     ) -> torch.Tensor:
    """Whisper-style bidirectional encoder over stub frame embeddings:
    sinusoidal positions, non-causal blocks without RoPE, final norm."""
    enc = params["encoder"]
    pos = torch.arange(frames.shape[1], device=frames.device,
                       dtype=torch.float32)
    freqs = torch.exp(-torch.arange(0, cfg.d_model, 2, device=frames.device,
                                    dtype=torch.float32)
                      / cfg.d_model * 9.21)
    ang = pos[:, None] * freqs[None, :]
    x = frames + torch.cat([torch.sin(ang), torch.cos(ang)],
                           dim=-1)[None].to(frames.dtype)
    for block in _unstack(enc["blocks"], cfg.encdec.encoder_layers):
        h = _norm(cfg, x, block["ln1"])
        h = attn_lib.attention_forward(
            block["attn"], h, num_heads=cfg.num_heads,
            num_kv_heads=cfg.num_kv_heads, rope_theta=0.0, causal=False)
        x = _mlp_res(cfg, block, x + h)
    return _norm(cfg, x, enc["final_norm"])


def _cross_source(cfg: ModelConfig, params: Dict, batch: Dict,
                  dtype: torch.dtype) -> Optional[torch.Tensor]:
    """What the cross blocks attend to: the projected image embeddings
    (vlm), the encoder's output over the frames (audio), else None."""
    if cfg.arch_type == "vlm":
        return batch["image_embeds"].to(dtype) @ params["projector"].to(dtype)
    if cfg.arch_type == "audio":
        return _encoder_forward(cfg, params,
                                batch["encoder_frames"].to(dtype))
    return None


def _hybrid_group(cfg: ModelConfig, group, x: torch.Tensor) -> torch.Tensor:
    """One group of the hybrid family: its Mamba2 layers, then the shared
    attention block (JAX's ``group`` step of the hybrid scan).
    ``group`` is (the group's layers, the shared block)."""
    blocks, shared = group
    for block in blocks:
        x = _ssm_block(cfg, block, x)
    return _mlp_res(cfg, shared, _self_attn(cfg, shared, x))


def _embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``.  Under a mesh, a vocabulary-parallel lookup
    (F0's layout: the table's rows over "model", the tokens over the batch
    axes): each device looks up the tokens of its batch shard that fall in
    its rows, zeros elsewhere, and the partial sums over "model" are
    reduced by the caller's ``constrain``.  DTensor's own strategies for
    this gather differ between PyTorch releases (an index backward that
    fails, a masked embedding whose mask mis-shapes on a 2-D mesh)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(table):
        return table[tokens]
    rows = clean_spec(table.shape, (MODEL, None), mesh_axis_sizes(mesh))[0]
    split = rows is not None

    def lookup(t, ids):
        start = mesh.get_local_rank(MODEL) * t.shape[0] if split else 0
        local = ids - start
        hit = (local >= 0) & (local < t.shape[0])
        out = t[torch.where(hit, local, 0)]
        return out * hit[..., None].to(out.dtype)

    shape = (*tokens.shape, table.shape[1])
    return shard_map(lookup, (pin(table), tokens),
                     ((MODEL, None), (BATCH, None)),
                     (((BATCH, None, None), shape),),
                     partial=(MODEL,) if split else ())


def _lm_head(cfg: ModelConfig, params: Dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return pin(params["embed"]).T
    return params["head"]


def _logits(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """(B, d) x (d, V) -> f32 logits.

    JAX takes these with preferred_element_type=f32: products of the
    working-dtype operands summed in f32.  A bf16 matmul would round its
    output to bf16, and greedy argmax flips on near ties.  Rounding the head
    to the working dtype (as JAX's ``astype``) and then casting both
    operands to f32 gives the same exact products and f32 sums.  It costs an
    f32 copy of the head (V * d * 4 bytes: 412 MB at olmo-1b) and a GEMM
    outside the bf16 tensor cores on every call.
    """
    return x.float() @ head.to(x.dtype).float()


# ---------------------------------------------------------------------------
# Decode path
# ---------------------------------------------------------------------------

def cache_length(cfg: ModelConfig, seq_len: int) -> int:
    """KV-cache length: ring buffer of `window` for SWA models, else seq_len."""
    if cfg.sliding_window:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int, *, device,
                      dtype=torch.bfloat16, conv_dtype=torch.float32) -> Dict:
    """The decode state, in the JAX state's keys and shapes:

    - ``pos``: a Python int, so the host decides cache slots and masks
      without reading the device;
    - ``kv`` {"k", "v": (L, B, cache_len, KVH, hd)} in ``dtype`` for
      dense, MoE, audio and VLM, with one entry per shared-attention
      application (n_groups) for hybrid;
    - ``cross_kv`` {"k", "v": (n, B, Skv, KVH, hd)} in ``dtype``: for VLM
      one entry per cross block over the image tokens, for audio one per
      decoder layer over the encoder frames;
    - ``ssm`` {"conv": (L, B, W-1, d_in+2N) in ``conv_dtype``, "ssm": (L, B,
      H, P, N) f32} for ssm and hybrid.  ``conv_dtype`` is f32 as in JAX's
      ``init_decode_state``; prefill passes the working dtype, which JAX's
      prefill state holds.
    """
    check_ported(cfg, serving=True)
    state: Dict = {"pos": 0}
    n_kv = {"ssm": None,
            "hybrid": num_shared_attn(cfg)}.get(cfg.arch_type, cfg.num_layers)

    def zeros_kv(n, length):
        shape = (n, batch, length, cfg.num_kv_heads, cfg.resolved_head_dim())
        return {"k": torch.zeros(shape, device=device, dtype=dtype),
                "v": torch.zeros(shape, device=device, dtype=dtype)}

    if n_kv is not None:
        state["kv"] = zeros_kv(n_kv, cache_length(cfg, seq_len))
    if cfg.arch_type in ("ssm", "hybrid"):
        per = ssm_lib.init_ssm_state(batch, cfg.d_model, cfg.ssm,
                                     device=device, dtype=conv_dtype)
        state["ssm"] = {key: val.new_zeros((cfg.num_layers, *val.shape))
                        for key, val in per.items()}
    if cfg.arch_type == "vlm":
        state["cross_kv"] = zeros_kv(num_cross_layers(cfg),
                                     cfg.vlm.num_image_tokens)
    if cfg.arch_type == "audio":
        state["cross_kv"] = zeros_kv(cfg.num_layers, cfg.encdec.encoder_seq)
    return state


def _self_attn_decode(cfg: ModelConfig, block: Dict, x: torch.Tensor,
                      kv: Dict, i: int, pos: int) -> torch.Tensor:
    """x + the attention of block ``block`` on one token with KV cache
    entry ``i``, written in place."""
    h = _norm(cfg, x, block["ln1"])
    h, _ = attn_lib.decode_attention(
        block["attn"], h, {"k": kv["k"][i], "v": kv["v"][i]}, pos,
        num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
        rope_theta=cfg.rope_theta, window=cfg.sliding_window)
    return x + h


def _attn_decode(cfg: ModelConfig, block: Dict, x: torch.Tensor, kv: Dict,
                 i: int, pos: int) -> torch.Tensor:
    """Attention block ``block`` on one token with KV cache entry ``i``,
    written in place; then its feed-forward.  The MoE layer routes the
    step's B tokens with their own capacity, as JAX's decode does."""
    return _ffn_res(cfg, block, _self_attn_decode(cfg, block, x, kv, i, pos))


def _cross_decode(cfg: ModelConfig, cblock: Dict, x: torch.Tensor,
                  cross_kv: Dict, i: int) -> torch.Tensor:
    """x + tanh(gate) * the cross attention of one token over entry ``i``
    of the cached cross K/V."""
    h = _norm(cfg, x, cblock["ln"])
    dtype = x.dtype
    h = attn_lib.decode_cross_attention(
        cblock["attn"], h, {"k": cross_kv["k"][i].to(dtype),
                            "v": cross_kv["v"][i].to(dtype)},
        num_heads=cfg.num_heads)
    return x + torch.tanh(cblock["gate"]).to(dtype) * h


def _ssm_decode(cfg: ModelConfig, block: Dict, x: torch.Tensor, sstate: Dict,
                i: int) -> torch.Tensor:
    """Mamba2 layer ``i`` on one token; its state is updated in place."""
    h = _norm(cfg, x, block["ln1"])
    h, new = ssm_lib.ssm_decode_step(
        block["ssm"], h, {"conv": sstate["conv"][i], "ssm": sstate["ssm"][i]},
        cfg.ssm, cfg.norm_eps)
    sstate["conv"][i] = new["conv"]
    sstate["ssm"][i] = new["ssm"]
    return x + h


def decode_step_fn(params: Dict, state: Dict, token: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One decode step.  token: (B,) int.  Returns (logits (B, V) f32, state).

    The KV and SSM caches in ``state`` are updated in place (see
    ``attention.decode_attention``) and ``state`` itself is returned with
    ``pos`` advanced.
    """
    check_ported(cfg, serving=True)
    dtype = torch_dtype(cfg.dtype)
    pos = state["pos"]
    x = _embed(params["embed"], token).to(dtype)[:, None]  # (B, 1, d)
    for kind, block, i in _layers(cfg, params):
        if kind == "ssm":
            x = _ssm_decode(cfg, block, x, state["ssm"], i)
        elif kind == "cross":
            x = _cross_decode(cfg, block, x, state["cross_kv"], i)
        elif kind == "audio":
            layer, cross = block
            x = _self_attn_decode(cfg, layer, x, state["kv"], i, pos)
            x = _cross_decode(cfg, cross, x, state["cross_kv"], i)
            x = _mlp_res(cfg, layer, x)
        else:
            x = _attn_decode(cfg, block, x, state["kv"], i, pos)
    x = _norm(cfg, x, params["final_norm"])
    logits = _logits(x[:, 0], _lm_head(cfg, params))
    state["pos"] = pos + 1
    return logits, state


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------

def _fill_cache(cfg: ModelConfig, cache_k: torch.Tensor, cache_v: torch.Tensor,
                k: torch.Tensor, v: torch.Tensor) -> None:
    """Write one layer's prompt k/v (B, S, KVH, hd) into its zeroed cache
    (B, clen, KVH, hd): the last ``clen`` positions in ring layout for
    sliding-window models, else positions 0..S-1 with zeros after them."""
    s, clen = k.shape[1], cache_k.shape[1]
    if is_dtensor(cache_k):
        # the whole cache's new content, written by one copy_: DTensor has
        # no strategy for a write into a slice of a dim split over "model"
        if cfg.sliding_window and s > clen:
            # torch.roll as two slices (no DTensor strategy rolls)
            r = s % clen
            new_k, new_v = (torch.cat([t[:, s - r:], t[:, s - clen:s - r]],
                                      dim=1) for t in (k, v))
        elif clen > s:
            grow = (0, 0, 0, 0, 0, clen - s)
            new_k, new_v = torch.nn.functional.pad(k, grow), \
                torch.nn.functional.pad(v, grow)
        else:
            new_k, new_v = k, v
        cache_k.copy_(new_k.to(cache_k.dtype))
        cache_v.copy_(new_v.to(cache_v.dtype))
    elif cfg.sliding_window and s > clen:
        # ring layout: position p lives at slot p % clen; after slicing the
        # last clen positions (s-clen .. s-1), original index i holds
        # position s-clen+i, whose slot is (i + s) % clen -> roll by s%clen.
        cache_k.copy_(torch.roll(k[:, -clen:], s % clen, dims=1))
        cache_v.copy_(torch.roll(v[:, -clen:], s % clen, dims=1))
    else:
        cache_k[:, :s] = k
        cache_v[:, :s] = v


def _self_attn_prefill(cfg: ModelConfig, block: Dict, x: torch.Tensor,
                       kv: Dict, i: int) -> torch.Tensor:
    """x + the attention of block ``block`` over the prompt, filling KV
    cache entry ``i``."""
    hn = _norm(cfg, x, block["ln1"])
    h, k, v = attn_lib.self_attention_with_kv(
        block["attn"], hn, num_heads=cfg.num_heads,
        rope_theta=cfg.rope_theta, window=cfg.sliding_window)
    _fill_cache(cfg, kv["k"][i], kv["v"][i], k, v)
    return x + h


def _attn_prefill(cfg: ModelConfig, block: Dict, x: torch.Tensor, kv: Dict,
                  i: int) -> torch.Tensor:
    """Attention block over the prompt, filling KV cache entry ``i``; then
    its feed-forward."""
    return _ffn_res(cfg, block, _self_attn_prefill(cfg, block, x, kv, i))


def _cross_prefill(cfg: ModelConfig, cblock: Dict, x: torch.Tensor,
                   cross_src: torch.Tensor, cross_kv: Dict, i: int
                   ) -> torch.Tensor:
    """The cross block over the prompt; its K/V over ``cross_src`` go into
    entry ``i`` of the cross cache."""
    ck = attn_lib.init_cross_cache(cblock["attn"], cross_src,
                                   num_kv_heads=cfg.num_kv_heads)
    cross_kv["k"][i] = ck["k"]
    cross_kv["v"][i] = ck["v"]
    return _cross_block(cfg, cblock, x, cross_src)


def _ssm_prefill_layer(cfg: ModelConfig, block: Dict, x: torch.Tensor,
                       sstate: Dict, i: int) -> torch.Tensor:
    """Mamba2 layer ``i`` over the full prompt; its decode state goes into
    entry ``i`` of ``sstate``."""
    h = _norm(cfg, x, block["ln1"])
    out, new = ssm_lib.ssm_prefill(block["ssm"], h, cfg.ssm, cfg.norm_eps)
    sstate["conv"][i] = new["conv"]
    sstate["ssm"][i] = new["ssm"]
    return x + out


def prefill_fn(params: Dict, batch: Dict, cfg: ModelConfig,
               cache_len: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Process a full prompt; returns (last-token logits (B, V) f32, decode
    state).

    ``cache_len`` sizes the decode cache (>= prompt length) so generation
    has headroom; default = prompt length.  The k/v each layer's attention
    projects are written into the cache as they are, where JAX projects
    them a second time; the cache comes out the same.  ``batch`` holds
    ``image_embeds`` (vlm) or ``encoder_frames`` (audio) beside the tokens.
    """
    check_ported(cfg, serving=True)
    tokens = batch["tokens"]
    b, s = tokens.shape
    target_len = cache_len if cache_len is not None else s
    if target_len < s:
        raise ValueError(f"cache_len {target_len} < prompt length {s}")
    dtype = torch_dtype(cfg.dtype)
    x = _embed(params["embed"], tokens).to(dtype)
    state = init_decode_state(cfg, b, target_len, device=x.device, dtype=dtype,
                              conv_dtype=dtype)
    if is_dtensor(x) and current_mesh() is not None:
        from repro_torch.parallel.sharding import (decode_state_specs,
                                                   distribute_tree)
        mesh = current_mesh()
        state = distribute_tree(state, decode_state_specs(state, mesh, b),
                                mesh)
    state["pos"] = s
    cross_src = _cross_source(cfg, params, batch, dtype)
    for kind, block, i in _layers(cfg, params):
        if kind == "ssm":
            x = _ssm_prefill_layer(cfg, block, x, state["ssm"], i)
        elif kind == "cross":
            x = _cross_prefill(cfg, block, x, cross_src, state["cross_kv"], i)
        elif kind == "audio":
            layer, cross = block
            x = _self_attn_prefill(cfg, layer, x, state["kv"], i)
            x = _cross_prefill(cfg, cross, x, cross_src, state["cross_kv"], i)
            x = _mlp_res(cfg, layer, x)
        else:
            x = _attn_prefill(cfg, block, x, state["kv"], i)
    x = _norm(cfg, x, params["final_norm"])
    logits = _logits(x[:, -1], _lm_head(cfg, params))
    return logits, state


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------

def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CE without materialising the (B, S, V) logits; labels < 0 are
    ignored.  Returns (sum_loss, token_count).

    JAX scans over 128-token chunks of the sequence with the whole vocab
    per chunk; here ``fused_cross_entropy`` streams the vocab instead (the
    Pallas kernel's schedule): the CUDA kernel on the card, its plain
    version on the CPU.  As in JAX, the head is rounded to the working
    dtype and the products are summed in f32.
    """
    if is_dtensor(hidden):
        return _sharded_cross_entropy(hidden, head, labels)
    d = hidden.shape[-1]
    return fused_cross_entropy(hidden.reshape(-1, d), head.to(hidden.dtype),
                               labels.reshape(-1))


LOSS_CHUNK = 128   # sequence chunk of the CE under a mesh, as JAX's


def _sharded_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                           labels: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX's ``chunked_cross_entropy`` on DTensors, vocabulary-parallel:
    the rows over the batch axes, the head's vocabulary over "model" where
    it divides.  Each device takes the (lse, label logit) of its rows over
    its slice of the vocabulary from ``fused_ce_shard_stats`` (the
    streaming kernel on the card, its plain version on the CPU), its
    labels moved to the slice's start, in JAX's 128-token chunks of the
    sequence, which bound the plain version's logits; the slices' lse then
    meet in a logsumexp and their label logits in a sum over "model"."""
    mesh = current_mesh()
    b, s, d = hidden.shape
    split = clean_spec(head.shape, (None, MODEL),
                       mesh_axis_sizes(mesh))[1] is not None
    parts = local_size(mesh, MODEL) if split else 1

    def stats(h, w, lab):
        if split:
            lab = lab - mesh.get_local_rank(MODEL) * w.shape[1]
        w = w.to(h.dtype)
        lse, pick = [], []
        for c0 in range(0, s, LOSS_CHUNK):
            lc = lab[:, c0:c0 + LOSS_CHUNK]
            a, p = fused_ce_shard_stats(
                h[:, c0:c0 + LOSS_CHUNK].reshape(-1, d), w, lc.reshape(-1))
            lse.append(a.reshape(lc.shape))
            pick.append(p.reshape(lc.shape))
        return torch.cat(lse, 1)[..., None], torch.cat(pick, 1)[..., None]

    out = ((BATCH, None, MODEL if split else None), (b, s, parts))
    lse, pick = (constrain(t, BATCH, None, None) for t in shard_map(
        stats, (hidden, head, labels),
        ((BATCH, None, None), (None, MODEL), (BATCH, None)), (out, out)))
    mx = lse.detach().amax(dim=-1, keepdim=True)
    lse = (lse - mx).exp().sum(dim=-1).log() + mx[..., 0]
    mask = (labels >= 0).float()
    return ((lse - pick.sum(dim=-1)) * mask).sum(), mask.sum()


# each family's unit of the training forward: a layer, for hybrid a group
# of layers and the shared block, for audio a decoder layer and its cross
# block, for vlm a group of layers and its cross block (``_train_units``)
TRAINED = {"dense": _dense_block, "moe": _moe_block, "ssm": _ssm_block,
           "hybrid": _hybrid_group, "audio": _audio_block,
           "vlm": _vlm_group, "interleaved": _interleaved_layer}

# the products JAX's ``dots_saveable`` keeps: matmuls (einsum and matmul
# reach these in ATen)
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                   torch.ops.aten.addmm.default,
                   torch.ops.aten.baddbmm.default})


def _save_dots(_ctx, op, *_args, **_kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def check_trainable(cfg: ModelConfig) -> None:
    if cfg.arch_type not in TRAINED:
        raise ValueError(f"{cfg.name}: unknown arch_type {cfg.arch_type!r}; "
                         f"the port trains the families {tuple(TRAINED)}")
    if _multiplied(cfg) and cfg.arch_type not in MULTIPLIED:
        raise ValueError(f"{cfg.name}: the {cfg.arch_type} family does not "
                         f"take the embedding, attention, residual or logit "
                         f"multipliers; {MULTIPLIED} do")
    check_ported(cfg)


def _remat_wrapper(remat: bool, policy: str = "full"):
    """``run(fn, *args)``: ``fn(*args)`` as it is, or under one
    ``torch.utils.checkpoint`` (JAX's ``_remat_wrapper``): "dots" saves
    the matmul outputs and recomputes the rest in the backward (JAX's
    ``dots_saveable``; the kernels' outputs are recomputed), any other
    policy recomputes the whole unit."""
    if not remat:
        return lambda fn, *args: fn(*args)
    extra = {}
    if policy == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False,
                                        **extra)


def _train_units(cfg: ModelConfig, params: Dict):
    """The units the training forward runs in turn, each under one
    checkpoint with remat, as JAX checkpoints each step of its scans: one
    per layer; for audio one per decoder layer with its cross block; for
    hybrid one per group (its ``attn_every`` Mamba2 layers and the shared
    block, whose weights so get the sum of the gradients of their
    applications), then one per tail layer; for vlm one per group (its
    ``cross_attn_every`` layers and its cross block); for interleaved one
    per layer of ``layer_types``, (kind, layer) from the stack of its kind.
    Yields (function, block), each unit's layers taken just before it runs
    (``_unstack``)."""
    if cfg.arch_type == "interleaved":
        n_mamba, n_attn = layer_counts(cfg)
        stacks = {"mamba": iter(_unstack(params["blocks"], n_mamba)),
                  "attention": iter(_unstack(params["attn_blocks"], n_attn))}
        for kind in cfg.layer_types:
            yield _interleaved_layer, (kind, next(stacks[kind]))
        return
    blocks = _unstack(params["blocks"], cfg.num_layers)
    if cfg.arch_type == "audio":
        cross = _unstack(params["cross"], cfg.num_layers)
        for i in range(cfg.num_layers):
            yield _audio_block, (blocks[i], cross[i])
        return
    if cfg.arch_type not in ("hybrid", "vlm"):
        for block in blocks:
            yield TRAINED[cfg.arch_type], block
        return
    n, per, tail = group_layout(cfg)
    if cfg.arch_type == "vlm":
        if tail:
            raise ValueError(f"{cfg.name}: vlm layers must divide "
                             f"cross_attn_every")
        cross = _unstack(params["cross"], n)
        for g in range(n):
            yield _vlm_group, (blocks[g * per:(g + 1) * per], cross[g])
        return
    for g in range(n):
        yield _hybrid_group, (blocks[g * per:(g + 1) * per],
                              params["shared_attn"])
    for i in range(n * per, cfg.num_layers):
        yield _ssm_block, blocks[i]


def model_forward(params: Dict, batch: Dict, cfg: ModelConfig,
                  remat: bool = True, remat_policy: str = "full"
                  ) -> Tuple[torch.Tensor, Dict]:
    """Training forward.  batch: tokens (B, S), labels (B, S) (< 0 =
    ignore) and, per family, image_embeds (B, N, image width) [vlm] or
    encoder_frames (B, F, d_model) [audio].  Returns (mean loss, metrics
    dict).

    The layers run as JAX's ``_scan_blocks`` runs them (``_train_units``),
    each unit under ``_remat_wrapper(remat, remat_policy)``; the audio
    encoder (or the VLM projector) runs once before them, outside any
    checkpoint, as in JAX.  The loss is the mean CE plus the MoE layers'
    summed aux losses (zero for the other families).  The embedding's
    output is multiplied by ``embedding_multiplier`` and the final norm's
    divided by ``logits_scaling``, each where it is off its default.
    """
    check_trainable(cfg)
    run = _remat_wrapper(remat, remat_policy)
    dtype = torch_dtype(cfg.dtype)
    x = constrain(_embed(params["embed"].to(dtype), batch["tokens"]), BATCH,
                  None, None)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    cross_src = _cross_source(cfg, params, batch, dtype)
    for fn, block in _train_units(cfg, params):
        if cfg.arch_type == "moe":
            x, layer_aux = run(fn, cfg, block, x)
            aux = aux + layer_aux
        elif cross_src is not None:
            x = run(fn, cfg, block, x, cross_src)
        else:
            x = run(fn, cfg, block, x)
    x = _norm(cfg, x, params["final_norm"])
    if cfg.logits_scaling != 1.0:
        x = x / cfg.logits_scaling
    loss_sum, count = chunked_cross_entropy(x, _lm_head(cfg, params),
                                            batch["labels"])
    ce = loss_sum / torch.clamp(count, min=1.0)
    return ce + aux, {"ce": ce, "aux": aux, "tokens": count}


def loss_fn(params: Dict, batch: Dict, cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    return model_forward(params, batch, cfg, remat=remat)[0]
