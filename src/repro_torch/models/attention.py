"""Attention: GQA, sliding window, KV-cache decode (port of
``repro.models.attention``).

The prefill core is the hand-written kernel behind
``kernels.swa_attention.swa_attention``; the JAX package runs
``blockwise_attention`` there, the jnp form of the same online softmax.
The one difference: the kernel scales in f32, as the Pallas ``swa_flash``
does, where ``blockwise_attention`` scales q in the working dtype.  The two
agree at f32 and differ by rounding at bf16.
Cross attention (``kv``) and non-causal self-attention (the audio
encoder) run ``full_attention``, a plain torch core: JAX routes them to
``blockwise_attention(causal=False)``, plain jnp and not a Pallas kernel
(the Pallas ``swa_flash`` is causal only).  Decode attention stays plain
torch, as it is plain jnp in JAX.

Under a mesh (``parallel/constraints.use_mesh``) the tensors are DTensors.
The ``constrain`` calls stand where JAX's do; the attention core runs on
each device's (batch, head) shard through ``shard_map``, whose input and
output specs stand for JAX's constraints on the blocked q/k/v and on the
scan's accumulators.  Heads that do not divide the "model" axis are padded
with zero heads (exact: sliced off after the core), as in JAX.  Where the
heads are fewer than the "model" axis, JAX shards the query blocks over it
(sequence parallel); here the non-causal core does the same and the causal
core runs replicated over "model" (``CHANGES.md``).  Outside a mesh every
``constrain`` is a no-op and the paths are the single-device ones.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models.common import apply_rope, dense_init
from repro_torch.parallel.constraints import (BATCH, MODEL, constrain,
                                              current_mesh, is_dtensor,
                                              local_size, shard_map)

NEG_INF = -1e30


def init_attention(gen: torch.Generator, d_model: int, num_heads: int,
                   num_kv_heads: int, head_dim: int, *, device,
                   dtype=torch.float32) -> Dict:
    def init(shape, scale=0.02):
        return dense_init(gen, shape, scale, device=device, dtype=dtype)

    return {
        "wq": init((d_model, num_heads, head_dim)),
        "wk": init((d_model, num_kv_heads, head_dim)),
        "wv": init((d_model, num_kv_heads, head_dim)),
        "wo": init((num_heads, head_dim, d_model), 0.02 / math.sqrt(2.0)),
    }


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, H, D) by repeating kv heads (GQA)."""
    kvh = k.shape[-2]
    if kvh == num_heads:
        return k
    return k.repeat_interleave(num_heads // kvh, dim=-2)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul.  Under a mesh the (heads x
    head dim) columns are pinned over "model" only where the heads divide
    it: a split inside a head cannot be unflattened (no DTensor strategy),
    and JAX's ``constrain`` over heads falls back to replicated there."""
    y = _pin_heads(x @ _merged(w.to(x.dtype), 1, 2), w.shape[1])
    return y.unflatten(-1, w.shape[1:])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul.  Under a mesh the merged
    (heads x head dim) activations are pinned as ``_project`` pins its
    output, for their gradient's unflatten."""
    return _pin_heads(o.flatten(2), o.shape[2]) @ _merged(wo.to(o.dtype),
                                                          0, 1)


def _pin_heads(y: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, S, heads x head dim) activations over "model" where ``heads``
    divides it, else replicated over it (a no-op without a mesh)."""
    if not is_dtensor(y):
        return y
    split = heads % local_size(current_mesh(), MODEL) == 0
    return constrain(y, BATCH, None, MODEL if split else None)


def _merged(w: torch.Tensor, start: int, end: int) -> torch.Tensor:
    """``w.flatten(start, end)``.  Under a mesh the merged weight is pinned
    to the split it inherits from ``w`` (a split of the outer merged dim,
    the heads, stays; one of an inner dim cannot be expressed), so that its
    gradient comes back in a split the unflatten can undo (DTensor has no
    strategy to split a dim that is split in another way)."""
    wf = w.flatten(start, end)
    if not is_dtensor(wf) or current_mesh() is None:
        return wf
    from torch.distributed.tensor import Shard

    axes = [[] for _ in range(wf.ndim)]
    for name, pl in zip(wf.device_mesh.mesh_dim_names, w.placements):
        if isinstance(pl, Shard) and not start < pl.dim <= end:
            axes[pl.dim if pl.dim <= start else pl.dim - end + start].append(
                name)
    return constrain(wf, *(None if not a else a[0] if len(a) == 1
                           else tuple(a) for a in axes))


HEADS = (BATCH, None, MODEL, None)      # (B, S, H, D) over heads
SEQ = (BATCH, MODEL, None, None)        # query positions over "model"
ROWS = (BATCH, None, None, None)        # replicated over "model"


def _sharded_core(core, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  nh: int, causal: bool) -> torch.Tensor:
    """``core(q, k, v)`` on each device's shard under a mesh: (batch, head)
    shards, after padding the heads to a multiple of the "model" axis
    (JAX's ``hpad``) when they are at least as many; with fewer heads,
    query positions over "model" for a non-causal core and no "model"
    split for a causal one.  Returns the (B, Sq, nh, D) output, over heads
    (JAX's ``o`` constraint)."""
    msz = local_size(current_mesh(), "model")
    hpad = (-nh) % msz if (msz > 1 and nh >= msz) else 0
    if hpad:   # zero heads, concatenated (some PyTorch cannot pad a DTensor)
        q, k, v = (constrain(torch.cat([t, torch.zeros(
            (*t.shape[:2], hpad, t.shape[3]), device=t.device,
            dtype=t.dtype)], dim=2), *HEADS) for t in (q, k, v))
    if msz > 1 and nh < msz:
        qs, kvs = (SEQ, ROWS) if not causal else (ROWS, ROWS)
    else:
        qs = kvs = HEADS
    o = shard_map(core, (q, k, v), (qs, kvs, kvs), (0,))
    if hpad:
        o = o[:, :, :nh]
    return constrain(o, *HEADS)


def _rescaled(q: torch.Tensor, softmax_scale: float) -> torch.Tensor:
    """q for a core that scales its scores by 1/sqrt(head_dim), so that
    they come out scaled by ``softmax_scale`` instead: q times
    softmax_scale * sqrt(head_dim), in q's dtype (exact in bf16 where that
    factor is a power of two, as granite's 1/64 at head dim 64 gives
    1/8).  ``softmax_scale`` 0 keeps the core's own scale and launches
    nothing."""
    if not softmax_scale:
        return q
    return q * (softmax_scale * math.sqrt(q.shape[-1]))


def self_attention_with_kv(params: Dict, x: torch.Tensor, *, num_heads: int,
                           rope_theta: float, window: int = 0,
                           softmax_scale: float = 0.0
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over positions 0..S-1, its scores scaled by
    ``softmax_scale`` (0: 1/sqrt(head_dim)).

    Returns (out (B, S, d_model), k, v), with k (after RoPE) and v the
    (B, S, KVH, hd) projections before the GQA repeat: what the prefill
    writes into the KV cache, so it need not project them again.
    """
    s = x.shape[1]
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    q = constrain(q, *HEADS)
    if rope_theta > 0:
        positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    q = _rescaled(q, softmax_scale)
    kr = constrain(_repeat_kv(k, num_heads), *HEADS)
    vr = constrain(_repeat_kv(v, num_heads), *HEADS)
    o = _sharded_core(lambda q_, k_, v_: swa_attention(q_, k_, v_,
                                                       window=window),
                      q, kr, vr, num_heads, causal=True)
    return constrain(_out_proj(o, params["wo"]), BATCH, None, None), k, v


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                   ) -> torch.Tensor:
    """Non-causal attention, every query over every key: JAX's
    ``blockwise_attention(causal=False)`` in one block.

    q: (B, Sq, H, D); k, v: (B, Skv, H, D) (kv already head-repeated).
    As there, q is scaled in the working dtype, the scores are summed in
    f32 from working-dtype operands (``preferred_element_type=f32``), the
    unnormalised probabilities are cast to v's dtype for P·V, summed in
    f32, and divided by their row sums.  Holds the (B, H, Sq, Skv) f32
    scores.  Returns (B, Sq, H, D) in q's dtype.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", (q * scale).float(), k.float())
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return (o / p.sum(dim=-1).transpose(1, 2)[..., None]).to(q.dtype)


def attention_forward(params: Dict, x: torch.Tensor, *, num_heads: int,
                      num_kv_heads: int, rope_theta: float, window: int = 0,
                      kv=None, causal: bool = True,
                      softmax_scale: float = 0.0) -> torch.Tensor:
    """Full attention layer (projections + core).

    kv: optional cross-attention source (B, Skv, d_model); None = self-attn.
    Causal self-attention runs the kernel core; cross attention and
    ``causal=False`` run ``full_attention`` (no RoPE on cross attention).
    ``softmax_scale`` goes to causal self-attention alone
    (``self_attention_with_kv``).
    """
    if kv is None and causal:
        return self_attention_with_kv(params, x, num_heads=num_heads,
                                      rope_theta=rope_theta, window=window,
                                      softmax_scale=softmax_scale)[0]
    src = x if kv is None else kv
    q = _project(x, params["wq"])
    k = _project(src, params["wk"])
    v = _project(src, params["wv"])
    q = constrain(q, *HEADS)
    if kv is None and rope_theta > 0:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    kr = constrain(_repeat_kv(k, num_heads), *HEADS)
    vr = constrain(_repeat_kv(v, num_heads), *HEADS)
    o = _sharded_core(full_attention, q, kr, vr, num_heads, causal=False)
    return constrain(_out_proj(o, params["wo"]), BATCH, None, None)


# ---------------------------------------------------------------------------
# Decode path (KV cache)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, cache_len: int, num_kv_heads: int, head_dim: int,
                  *, device, dtype=torch.bfloat16) -> Dict:
    shape = (batch, cache_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, device=device, dtype=dtype),
            "v": torch.zeros(shape, device=device, dtype=dtype)}


def decode_attention(params: Dict, x: torch.Tensor, cache: Dict, pos: int,
                     *, num_heads: int, num_kv_heads: int, rope_theta: float,
                     window: int = 0) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: x (B, 1, d_model), cache holds cache_len positions.

    For sliding-window models the cache is a ring buffer of size window;
    ``pos`` is the absolute position of the new token.  Unlike the JAX
    version, which returns a new cache, this writes the one new slot into
    ``cache`` in place and returns it, which saves a copy of the whole
    cache per layer and step.  Returns (out (B, 1, d_model), cache).
    """
    if x.shape[1] != 1:
        raise ValueError(f"decode takes one token per row, got {x.shape[1]}")
    b = x.shape[0]
    cache_len = cache["k"].shape[1]
    # decode sharding: batch over data, the CACHE LENGTH over model (GQA
    # kv heads are too few to shard 16-way); heads stay replicated and the
    # softmax reduces over model-sharded cache segments
    q = constrain(_project(x, params["wq"]), BATCH, None, None, None)
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if rope_theta > 0:
        p = torch.full((b, 1), pos, device=x.device)
        q = apply_rope(q, p, rope_theta)
        k = apply_rope(k, p, rope_theta)

    slot = (pos % cache_len) if window else min(pos, cache_len - 1)
    write_slot(cache["k"], slot, k[:, 0])
    write_slot(cache["v"], slot, v[:, 0])

    kk = constrain(_repeat_kv(cache["k"].to(x.dtype), num_heads),
                   BATCH, MODEL, None, None)
    vv = constrain(_repeat_kv(cache["v"].to(x.dtype), num_heads),
                   BATCH, MODEL, None, None)
    scale = 1.0 / math.sqrt(q.shape[-1])
    # scores in f32 from working-dtype operands, as JAX's
    # preferred_element_type=f32: bf16 products are exact in f32
    s = torch.einsum("bshk,bthk->bhst", (q * scale).float(), kk.float())
    s = constrain(s, BATCH, None, None, MODEL)
    idx = torch.arange(cache_len, device=x.device)
    if window:
        # ring buffer: valid slots are those written within the last
        # `window` absolute positions <= pos.
        age = (slot - idx) % cache_len
        valid = age < min(pos + 1, cache_len)
    else:
        valid = idx <= pos
    s = s.masked_fill(~valid, NEG_INF)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthk->bshk", p, vv)
    return _out_proj(o, params["wo"]), cache


def write_slot(cache: torch.Tensor, slot: int, val: torch.Tensor) -> None:
    """``cache[:, slot] = val`` in the cache's dtype, in place.  Under a
    mesh the cache (B, C, ...) is a DTensor whose length C may be split
    over "model": each device writes the slot if its segment holds it (no
    DTensor strategy writes one index of a sharded dim)."""
    val = val.to(cache.dtype)
    mesh = current_mesh()
    if mesh is None or not is_dtensor(cache):
        cache[:, slot] = val
        return
    from torch.distributed.tensor import Shard

    names = list(mesh.mesh_dim_names)
    spec = tuple(tuple(a for a, pl in zip(names, cache.placements)
                       if isinstance(pl, Shard) and pl.dim == d) or None
                 for d in range(cache.ndim))
    seg = [names.index(a) for a in (spec[1] or ())]

    def write(c, v_):
        start = 0
        for i in seg:       # major first: this device's offset along C
            start = start * mesh.size(i) + mesh.get_local_rank(i)
        start *= c.shape[1]
        if start <= slot < start + c.shape[1]:
            c[:, slot - start] = v_
        return c

    vspec = (spec[0],) + (None,) * (val.ndim - 1)
    shard_map(write, (cache, val), (spec, vspec), (0,))


def init_cross_cache(params: Dict, kv_src: torch.Tensor, *,
                     num_kv_heads: int) -> Dict:
    """Precompute cross-attention K/V (B, Skv, KVH, hd) from encoder or
    vision embeddings, in their dtype."""
    return {"k": _project(kv_src, params["wk"]),
            "v": _project(kv_src, params["wv"])}


def decode_cross_attention(params: Dict, x: torch.Tensor, cross: Dict, *,
                           num_heads: int) -> torch.Tensor:
    """Cross attention for decode: full (non-causal) attention of the one
    token over the cached cross K/V."""
    q = _project(x, params["wq"])
    kk = _repeat_kv(cross["k"].to(x.dtype), num_heads)
    vv = _repeat_kv(cross["v"].to(x.dtype), num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bshk,bthk->bhst", (q * scale).float(), kk.float())
    p = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum("bhst,bthk->bshk", p, vv)
    return _out_proj(o, params["wo"])
