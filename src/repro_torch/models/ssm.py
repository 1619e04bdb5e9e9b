"""Mamba2 / SSD (state-space duality) block, arXiv:2405.21060 (port of
``repro.models.ssm``).

Prefill runs the chunked SSD algorithm through ``ssd_chunked``, whose
intra-chunk step is the hand-written kernel behind
``kernels.ssd_scan`` (the JAX package's model calls the pure-jnp scan,
the drop-in twin of its Pallas kernel).  Decode is the O(1) recurrent
update on the (B, H, P, N) state, plain torch as it is plain jnp in JAX.
Under a mesh the scan runs on each device's (batch, head) shard
(``_sharded_ssd``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.models.common import dense_init, rmsnorm
from repro_torch.parallel.constraints import BATCH, MODEL, constrain, shard_map
from repro_torch.utils.spans import span

# leaves kept in f32 whatever the model's dtype, as JAX keeps and uses them
F32_LEAVES = ("A_log", "D", "dt_bias")


def _dims(d_model: int, cfg: SSMConfig) -> Tuple[int, int, int]:
    """(d_in, nheads, state_dim)."""
    d_in = cfg.expand * d_model
    return d_in, d_in // cfg.head_dim, cfg.state_dim


def init_ssm(gen: torch.Generator, d_model: int, cfg: SSMConfig, *, device,
             dtype=torch.float32) -> Dict:
    d_in, nheads, n = _dims(d_model, cfg)
    conv_ch = d_in + 2 * n
    f32 = dict(device=device, dtype=torch.float32)
    return {
        # in_proj -> [z (d_in), x (d_in), B (N), C (N), dt (H)]
        "in_proj": dense_init(gen, (d_model, 2 * d_in + 2 * n + nheads),
                              device=device, dtype=dtype),
        "conv_w": dense_init(gen, (cfg.conv_width, conv_ch), 0.1,
                             device=device, dtype=dtype),
        "conv_b": torch.zeros(conv_ch, device=device, dtype=dtype),
        "A_log": torch.zeros(nheads, **f32),          # A = -exp(A_log) = -1
        "D": torch.ones(nheads, **f32),
        "dt_bias": torch.full((nheads,), -2.0, **f32),  # softplus(-2) ~ 0.13
        "norm_scale": torch.ones(d_in, device=device, dtype=dtype),
        "out_proj": dense_init(gen, (d_in, d_model), device=device,
                               dtype=dtype),
    }


def _split_proj(proj: torch.Tensor, d_in: int, n: int, nheads: int):
    z = proj[..., :d_in]
    xbc = proj[..., d_in:d_in + d_in + 2 * n]
    dt = proj[..., d_in + d_in + 2 * n:]
    assert dt.shape[-1] == nheads
    return z, xbc, dt


def ssm_prefill(params: Dict, xin: torch.Tensor, cfg: SSMConfig,
                eps: float = 1e-6) -> Tuple[torch.Tensor, Dict]:
    """The Mamba2 block over a whole sequence: in_proj -> conv -> SSD ->
    gated norm (at ``eps``) -> out_proj.  xin: (B, L, d_model).

    Returns (out (B, L, d_model), decode state): ``conv``, the last W-1
    conv inputs in the working dtype (zeros where the prompt is shorter),
    and ``ssm``, the final (B, H, P, N) state in f32.  The span
    ``ssm.mixer`` holds the whole block, ``ssm.scan`` the SSD in it.
    """
    with span("ssm.mixer"):
        return _mixer(params, xin, cfg, eps)


def _mixer(params: Dict, xin: torch.Tensor, cfg: SSMConfig, eps: float
           ) -> Tuple[torch.Tensor, Dict]:
    bsz, l, d_model = xin.shape
    d_in, nheads, n = _dims(d_model, cfg)
    dtype = xin.dtype

    proj = xin @ params["in_proj"].to(dtype)
    z, xbc, dt = _split_proj(proj, d_in, n, nheads)

    # causal depthwise conv over the (x, B, C) channels: a Python sum of
    # the taps in the working dtype, in JAX's order
    w = params["conv_w"].to(dtype)                          # (W, ch)
    # the W-1 zeros in front by a concatenation, not F.pad: the same values,
    # and a DTensor split over the channels concatenates in every PyTorch
    zeros = torch.zeros((bsz, cfg.conv_width - 1, xbc.shape[-1]),
                        device=xbc.device, dtype=xbc.dtype)
    xp = torch.cat([zeros, xbc], dim=1)
    conv = sum(xp[:, i:i + l] * w[i] for i in range(cfg.conv_width))
    conv = F.silu(conv + params["conv_b"].to(dtype))

    xs = constrain(conv[..., :d_in].unflatten(-1, (nheads, cfg.head_dim)),
                   BATCH, None, MODEL, None)
    bmat = conv[..., d_in:d_in + n]
    cmat = conv[..., d_in + n:]

    # dt over heads, as dt_bias is: DTensor (some releases) cannot add a
    # head-split bias to the column slice of in_proj's output otherwise
    dt = F.softplus(constrain(dt.float(), BATCH, None, MODEL)
                    + params["dt_bias"])
    a = -torch.exp(params["A_log"])
    with span("ssm.scan"):
        y, final = _sharded_ssd(xs, dt, a, bmat, cmat, cfg.chunk_size)
    # D x in f32 on y already rounded to x's dtype, as JAX does
    y = y + params["D"][:, None] * xs.float()
    y = y.reshape(bsz, l, d_in).to(dtype)

    y = y * F.silu(z)
    y = rmsnorm(y, params["norm_scale"], eps)
    out = y @ params["out_proj"].to(dtype)
    return out, {"conv": xp[:, l:], "ssm": final}


def _sharded_ssd(xs, dt, a, bmat, cmat, chunk: int):
    """``ssd_chunked`` on each device's (batch, head) shard under a mesh:
    heads are independent and B, C are shared by them, so x (B, L, H, P),
    dt (B, L, H) and A (H) go over "model" on H and B, C (B, L, N) are
    replicated over it (no DTensor strategy splits the scan's cumulative
    sums; JAX pins x over heads likewise).  Without a mesh it is
    ``ssd_chunked``."""
    bsz, _, h, p = xs.shape
    heads = (BATCH, None, MODEL)
    return shard_map(
        lambda x_, dt_, a_, b_, c_: ssd_chunked(x_, dt_, a_, b_, c_, chunk),
        (xs, dt, a, bmat, cmat),
        ((BATCH, None, MODEL, None), heads, (MODEL,), (BATCH, None, None),
         (BATCH, None, None)),
        (0, ((BATCH, MODEL, None, None), (bsz, h, p, bmat.shape[-1]))))


def ssm_forward(params: Dict, xin: torch.Tensor, cfg: SSMConfig,
                eps: float = 1e-6) -> torch.Tensor:
    """Full Mamba2 block: in_proj -> conv -> SSD -> gated norm -> out_proj."""
    return ssm_prefill(params, xin, cfg, eps)[0]


# ---------------------------------------------------------------------------
# Decode path (recurrent state)
# ---------------------------------------------------------------------------

def init_ssm_state(batch: int, d_model: int, cfg: SSMConfig, *, device,
                   dtype=torch.float32) -> Dict:
    d_in, nheads, n = _dims(d_model, cfg)
    return {
        "conv": torch.zeros(batch, cfg.conv_width - 1, d_in + 2 * n,
                            device=device, dtype=dtype),
        "ssm": torch.zeros(batch, nheads, cfg.head_dim, n, device=device,
                           dtype=torch.float32),
    }


def ssm_decode_step(params: Dict, xin: torch.Tensor, state: Dict,
                    cfg: SSMConfig, eps: float = 1e-6
                    ) -> Tuple[torch.Tensor, Dict]:
    """One-token recurrent step.  xin: (B, 1, d_model).

    Returns (out (B, 1, d_model), new state); ``state`` is not changed.
    """
    bsz, _, d_model = xin.shape
    d_in, nheads, n = _dims(d_model, cfg)
    dtype = xin.dtype

    proj = xin[:, 0] @ params["in_proj"].to(dtype)
    z, xbc, dt = _split_proj(proj, d_in, n, nheads)

    # conv ring: the state holds the previous W-1 inputs.  A fresh state's
    # f32 conv promotes the step to f32, as in JAX
    hist = torch.cat([state["conv"], xbc[:, None]], dim=1)   # (B, W, ch)
    conv = torch.einsum("bwc,wc->bc", hist,
                        params["conv_w"].to(dtype).to(hist.dtype))
    conv = F.silu(conv + params["conv_b"].to(dtype))

    xs = conv[:, :d_in].reshape(bsz, nheads, cfg.head_dim)
    bmat = conv[:, d_in:d_in + n]
    cmat = conv[:, d_in + n:]

    dtp = F.softplus(dt.float() + params["dt_bias"])             # (B, H)
    a = -torch.exp(params["A_log"])
    decay = torch.exp(dtp * a)
    # h' = decay h + dt * B (x) x, as broadcasts: a three-operand
    # torch.einsum plans its contraction order on the host at every call
    upd = (dtp[:, :, None] * xs.float())[..., None] * bmat.float()[:, None, None]
    h_new = state["ssm"] * decay[:, :, None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat.float(), h_new)
    y = y + params["D"][:, None] * xs.float()
    y = y.reshape(bsz, d_in).to(dtype)

    y = y * F.silu(z)
    y = rmsnorm(y, params["norm_scale"], eps)
    out = y @ params["out_proj"].to(dtype)
    return out[:, None], {"conv": hist[:, 1:], "ssm": h_new}
