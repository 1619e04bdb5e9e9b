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
torch, as it is plain jnp in JAX.  There is one device, so the JAX
sharding constraints and mesh branches have no counterpart here.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.kernels.swa_attention import swa_attention
from repro_torch.models.common import apply_rope, dense_init

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
    """einsum("bsd,dhk->bshk") as one matmul."""
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, w.shape[1:])


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matmul."""
    return o.flatten(2) @ wo.to(o.dtype).flatten(0, 1)


def self_attention_with_kv(params: Dict, x: torch.Tensor, *, num_heads: int,
                           rope_theta: float, window: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over positions 0..S-1.

    Returns (out (B, S, d_model), k, v), with k (after RoPE) and v the
    (B, S, KVH, hd) projections before the GQA repeat: what the prefill
    writes into the KV cache, so it need not project them again.
    """
    s = x.shape[1]
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if rope_theta > 0:
        positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = swa_attention(q, _repeat_kv(k, num_heads), _repeat_kv(v, num_heads),
                      window=window)
    return _out_proj(o, params["wo"]), k, v


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
                      kv=None, causal: bool = True) -> torch.Tensor:
    """Full attention layer (projections + core).

    kv: optional cross-attention source (B, Skv, d_model); None = self-attn.
    Causal self-attention runs the kernel core; cross attention and
    ``causal=False`` run ``full_attention`` (no RoPE on cross attention).
    """
    if kv is None and causal:
        return self_attention_with_kv(params, x, num_heads=num_heads,
                                      rope_theta=rope_theta, window=window)[0]
    src = x if kv is None else kv
    q = _project(x, params["wq"])
    k = _project(src, params["wk"])
    v = _project(src, params["wv"])
    if kv is None and rope_theta > 0:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    o = full_attention(q, _repeat_kv(k, num_heads), _repeat_kv(v, num_heads))
    return _out_proj(o, params["wo"])


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
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if rope_theta > 0:
        p = torch.full((b, 1), pos, device=x.device)
        q = apply_rope(q, p, rope_theta)
        k = apply_rope(k, p, rope_theta)

    slot = (pos % cache_len) if window else min(pos, cache_len - 1)
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)

    kk = _repeat_kv(cache["k"].to(x.dtype), num_heads)
    vv = _repeat_kv(cache["v"].to(x.dtype), num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    # scores in f32 from working-dtype operands, as JAX's
    # preferred_element_type=f32: bf16 products are exact in f32
    s = torch.einsum("bshk,bthk->bhst", (q * scale).float(), kk.float())
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
