"""The plain reference of the interleaved family's training step:
granite-4.0-h (``granitemoehybrid``), Mamba2 and NoPE GQA layers in the
order of ``layer_types``, each followed by its own SwiGLU MLP.

Plain PyTorch in f32, with TF32 off, written from the published
description (the model's ``config.json`` and the Mamba2 paper,
arXiv:2405.21060) and importing nothing of the program.  It takes the
weights and batches the benchmark draws from the seed and runs the job's
first steps as the program's spliced step defines them:

- the embedding's output times ``embedding_multiplier``;
- a layer is h = x + r mixer(rmsnorm(x)), then h + r mlp(rmsnorm(h)),
  with r the ``residual_multiplier`` and every RMSNorm at the reference
  block's ``rms_eps``;
- attention: causal, no position encoding, the KV heads repeated for GQA,
  the scores scaled by ``attention_multiplier``;
- the Mamba2 mixer: in_proj to [z, x, B, C, dt]; a depthwise causal
  convolution with bias over (x, B, C), then SiLU; dt = softplus(dt +
  dt_bias), A = -exp(A_log); the SSD over chunks of the reference block's
  ``ssd_chunk`` (256, as published; the program scans in chunks of its
  own, and the output does not depend on the chunk but for rounding): in
  each chunk the quadratic form y_t = sum_{s <= t} (C_t . B_s)
  exp(cum_t - cum_s) dt_s x_s, with cum the running sum of dt A; the
  state each chunk leaves, sum_s exp(cum_end - cum_s) dt_s x_s B_s^T; the
  recurrence across chunks, S_in(k + 1) = exp(cum_end(k)) S_in(k) +
  state(k); and y_t += exp(cum_t) C_t . S_in; then y + D x, the gated
  RMSNorm rmsnorm(y silu(z)) over the whole inner width (one group), and
  out_proj;
- the final norm's output over ``logits_scaling``, the tied head, the mean
  cross entropy; each slice's loss over ``splice`` slices, and AdamW as
  ``transformer.train`` runs it.

``matmul="fp8"`` is the control of ``transformer``: every product's
operands rounded to fp8, the SSD's four products included.

Memory: each layer runs under a checkpoint, the attention core and the SSD
of one sequence at a time under their own, and the loss a chunk of rows at
a time, so the largest buffers are one sequence's (heads, S, S) scores.

The module also gives the family's parameter ``layout``, Mamba2's
initial ranges (``DRAWS``: the published model's A in [1, 16], dt in
[1e-3, 1e-1], D ones, which ``config.json`` does not give) and the step's
model FLOPs (``step_flops``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from bench import costs
from bench.reference.transformer import (CE_ROWS, MATMULS, _at, _layers,
                                         _leaf_sq, lr_at)

STACKS = {"mamba": "blocks", "attention": "attn_blocks"}
DRAWS = {"A_log": ("log_of_uniform", 1.0, 16.0),
         "dt_bias": ("dt_bias", 1e-3, 1e-1),
         "D": ("ones",), "conv_b": ("zeros",)}


def _dims(model: dict) -> Tuple[int, int, int, int]:
    """(inner width, SSD heads, state size, head size) of the Mamba2
    mixer."""
    s = model["ssm"]
    d_in = s["expand"] * model["d_model"]
    return d_in, d_in // s["head_dim"], s["state_dim"], s["head_dim"]


def layout(model: dict) -> dict:
    """The parameter tree as the port holds it: ``blocks`` the stacked
    Mamba2 layers with their MLPs, ``attn_blocks`` the stacked attention
    layers with theirs."""
    if model["arch_type"] != "interleaved":
        raise ValueError(f"arch_type {model['arch_type']!r}: this module "
                         f"draws the interleaved family")
    d, v, ff = model["d_model"], model["vocab_size"], model["d_ff"]
    h, kvh = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // h
    kinds = model["layer_types"]
    nm, na = kinds.count("mamba"), kinds.count("attention")
    d_in, heads, n, _ = _dims(model)
    conv = d_in + 2 * n

    def mlp(k):
        return {"wi": (k, d, ff), "wg": (k, d, ff), "wo": (k, ff, d)}

    tree = {"embed": (v, d), "final_norm": {"scale": (d,)}}
    if not model.get("tie_embeddings"):
        tree["head"] = (d, v)
    tree["blocks"] = {
        "ln1": {"scale": (nm, d)},
        "ssm": {"in_proj": (nm, d, 2 * d_in + 2 * n + heads),
                "conv_w": (nm, model["ssm"]["conv_width"], conv),
                "conv_b": (nm, conv), "A_log": (nm, heads), "D": (nm, heads),
                "dt_bias": (nm, heads), "norm_scale": (nm, d_in),
                "out_proj": (nm, d_in, d)},
        "ln2": {"scale": (nm, d)}, "mlp": mlp(nm)}
    tree["attn_blocks"] = {
        "ln1": {"scale": (na, d)},
        "attn": {"wq": (na, d, h, hd), "wk": (na, d, kvh, hd),
                 "wv": (na, d, kvh, hd), "wo": (na, h, hd, d)},
        "ln2": {"scale": (na, d)}, "mlp": mlp(na)}
    return tree


def step_flops(model: dict, tokens_per_row: int, rows: int) -> int:
    """Model FLOPs of one training step over ``rows`` sequences of
    ``tokens_per_row``, recomputation not counted:

    - 6 N T for the products with weights (forward 2, backward 4): N the
      in_proj, out_proj and MLP of each Mamba2 layer, the q, k, v, o
      projections and MLP of each attention layer, and the head (tied: the
      table once); the depthwise conv is no matrix and not counted;
    - 3x the causal attention forward's score and value products
      (``costs.attention_fwd``) in each attention layer;
    - 3x the SSD's intra-chunk products in each Mamba2 layer, 2 T Q H
      (N + P) at the configuration's chunk Q: C B^T and its product with x
      over the chunk, for every head."""
    d, v, ff = model["d_model"], model["vocab_size"], model["d_ff"]
    h, kvh = model["num_heads"], model["num_kv_heads"]
    hd = model.get("head_dim") or d // h
    kinds = model["layer_types"]
    nm, na = kinds.count("mamba"), kinds.count("attention")
    d_in, heads, n, p = _dims(model)
    mlp = 3 * d * ff
    mamba = d * (2 * d_in + 2 * n + heads) + d_in * d + mlp
    attn = 2 * d * h * hd + 2 * d * kvh * hd + mlp
    params = nm * mamba + na * attn + d * v
    t = tokens_per_row * rows
    core = 3 * costs.attention_fwd(rows, tokens_per_row, h, hd).flops
    ssd = 2 * t * model["ssm"]["chunk_size"] * heads * (n + p)
    return 6 * params * t + na * core + 3 * nm * ssd


class GraniteHybrid:
    """The model of a configuration's ``model`` block (the port's field
    names) and ``reference`` block (``rms_eps``, ``ssd_chunk``)."""

    def __init__(self, model: dict, semantics: dict, matmul: str = "f32"):
        self.m, self.sem, self.mm = model, semantics, MATMULS[matmul]
        self.d, self.h = model["d_model"], model["num_heads"]
        self.kvh = model["num_kv_heads"]
        self.hd = model.get("head_dim") or self.d // self.h
        self.d_in, self.heads, self.n, self.p = _dims(model)
        self.width = model["ssm"]["conv_width"]
        self.chunk = semantics["ssd_chunk"]
        self.rm = model.get("residual_multiplier", 1.0)
        self.scale = (model.get("attention_multiplier")
                      or 1.0 / math.sqrt(self.hd))

    # ------------------------------------------------------------ pieces
    def norm(self, x, w):
        var = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.sem["rms_eps"]) * w

    def _core(self, q, k, v):
        """One sequence's causal attention: q, k, v (S, H, hd)."""
        q, k, v = (t.transpose(0, 1) for t in (q, k, v))
        s = self.mm(q, k.mT) * self.scale
        n = s.shape[-1]
        hidden = torch.ones(n, n, dtype=torch.bool, device=s.device).triu_(1)
        p = torch.softmax(s.masked_fill(hidden, float("-inf")), dim=-1)
        return self.mm(p, v).transpose(0, 1)

    def attention(self, x, ln, wq, wk, wv, wo):
        r, s, d = x.shape
        h = self.norm(x, ln).reshape(r * s, d)
        q = self.mm(h, wq.reshape(d, -1)).view(r, s, self.h, self.hd)
        k = self.mm(h, wk.reshape(d, -1)).view(r, s, self.kvh, self.hd)
        v = self.mm(h, wv.reshape(d, -1)).view(r, s, self.kvh, self.hd)
        rep = self.h // self.kvh
        k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
        o = torch.stack([checkpoint(self._core, q[i], k[i], v[i],
                                    use_reentrant=False) for i in range(r)])
        out = self.mm(o.reshape(r * s, -1), wo.reshape(-1, d)).view(r, s, d)
        return x + self.rm * out

    def mlp(self, x, ln, wi, wg, wo):
        r, s, d = x.shape
        h = self.norm(x, ln).reshape(r * s, d)
        y = self.mm(F.silu(self.mm(h, wg)) * self.mm(h, wi), wo)
        return x + self.rm * y.view(r, s, d)

    def ssd(self, x, dt, a, b, c):
        """The SSD of one or more sequences over chunks of ``ssd_chunk``:
        x (r, S, H, P), dt (r, S, H), a (H,), b, c (r, S, N) -> y (r, S,
        H, P).  Past the sequence's end the chunk is padded with zeros (dt
        0: no decay and no input)."""
        r, s, h, p = x.shape
        q, n = self.chunk, b.shape[-1]
        pad = (-s) % q
        if pad:
            x, dt, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                           for t in (x, dt, b, c))
        nc = x.shape[1] // q
        xq = x.view(r, nc, q, h, p).transpose(2, 3)          # (r, nc, H, Q, P)
        dq = dt.view(r, nc, q, h).transpose(2, 3)            # (r, nc, H, Q)
        bq, cq = b.view(r, nc, q, n), c.view(r, nc, q, n)
        cum = torch.cumsum(dq * a[:, None], dim=-1)
        # within a chunk: the pairs s <= t, decayed from s to t
        causal = torch.ones(q, q, dtype=torch.bool, device=x.device).tril_()
        decay = (cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~causal, float("-inf")).exp()                    # (.., t, s)
        cb = self.mm(cq, bq.mT)                              # (r, nc, Q, Q)
        y = self.mm(cb[:, :, None] * decay * dq[..., None, :], xq)
        # the state each chunk leaves, and the recurrence across chunks
        w = (cum[..., -1:] - cum).exp() * dq
        states = self.mm((xq * w[..., None]).mT, bq[:, :, None])
        through = cum[..., -1].exp()                         # (r, nc, H)
        run = x.new_zeros(r, h, p, n)
        entering = []
        for k in range(nc):
            entering.append(run)
            run = run * through[:, k, :, None, None] + states[:, k]
        s_in = torch.stack(entering, 1)                      # (r, nc, H, P, N)
        y = y + self.mm(cq[:, :, None], s_in.mT) * cum.exp()[..., None]
        return y.transpose(2, 3).reshape(r, nc * q, h, p)[:, :s]

    def mamba(self, x, ln, in_proj, conv_w, conv_b, a_log, d_skip, dt_bias,
              norm_scale, out_proj):
        r, s, d = x.shape
        d_in, n, heads = self.d_in, self.n, self.heads
        h = self.norm(x, ln).reshape(r * s, d)
        proj = self.mm(h, in_proj).view(r, s, -1)
        z, xbc, dt = proj.split([d_in, d_in + 2 * n, heads], dim=-1)
        # depthwise causal conv: out_t = sum_k w_k x_{t - (W - 1) + k} + b
        xp = F.pad(xbc, (0, 0, self.width - 1, 0))
        conv = sum(xp[:, k:k + s] * conv_w[k] for k in range(self.width))
        xbc = F.silu(conv + conv_b)
        xs, b, c = xbc.split([d_in, n, n], dim=-1)
        xs = xs.reshape(r, s, heads, self.p)
        dt = F.softplus(dt + dt_bias)
        a = -torch.exp(a_log)
        y = torch.cat([checkpoint(self.ssd, xs[i:i + 1], dt[i:i + 1], a,
                                  b[i:i + 1], c[i:i + 1],
                                  use_reentrant=False) for i in range(r)])
        y = (y + d_skip[:, None] * xs).reshape(r, s, d_in)
        y = self.norm(y * F.silu(z), norm_scale)
        out = self.mm(y.reshape(r * s, d_in), out_proj).view(r, s, d)
        return x + self.rm * out

    def layer(self, kind, x, *weights):
        """One layer: its mixer, then its MLP (the last four weights)."""
        mixer = self.mamba if kind == "mamba" else self.attention
        return self.mlp(mixer(x, *weights[:-4]), *weights[-4:])

    def _ce_chunk(self, x, head, labels):
        lg = self.mm(x, head)
        return (torch.logsumexp(lg, -1)
                - lg.gather(1, labels[:, None])[:, 0]).sum()

    # ------------------------------------------------------------ a slice
    def loss(self, p: Dict[str, object], tokens, labels):
        """The slice's mean CE.  ``p`` maps each leaf's path to its tensor,
        and each stacked leaf to the list of its layers."""
        r, s = tokens.shape
        x = p["embed"][tokens] * self.m.get("embedding_multiplier", 1.0)
        names = {"mamba": ("ln1.scale", "ssm.in_proj", "ssm.conv_w",
                           "ssm.conv_b", "ssm.A_log", "ssm.D", "ssm.dt_bias",
                           "ssm.norm_scale", "ssm.out_proj"),
                 "attention": ("ln1.scale", "attn.wq", "attn.wk", "attn.wv",
                               "attn.wo")}
        taken = {"mamba": 0, "attention": 0}
        for kind in self.m["layer_types"]:
            i, stack = taken[kind], STACKS[kind]
            taken[kind] += 1
            weights = [p[f"{stack}.{name}"][i]
                       for name in (*names[kind], "ln2.scale", "mlp.wi",
                                    "mlp.wg", "mlp.wo")]
            x = checkpoint(self.layer, kind, x, *weights,
                           use_reentrant=False)
        x = self.norm(x, p["final_norm.scale"]).reshape(r * s, -1)
        x = x / self.m.get("logits_scaling", 1.0)
        head = p["head"] if "head" in p else p["embed"].t()
        flat = labels.reshape(-1)
        return sum(checkpoint(self._ce_chunk, x[c:c + CE_ROWS], head,
                              flat[c:c + CE_ROWS], use_reentrant=False)
                   for c in range(0, r * s, CE_ROWS)) / (r * s)


def train(model: dict, semantics: dict, optim: dict,
          initial: Callable[[str], torch.Tensor], paths: Sequence[str],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], splice: int,
          matmul: str = "f32") -> dict:
    """The first ``len(batches)`` steps of the job from ``initial(path)``,
    with the readings of ``transformer.train``: ``losses``, ``grad1`` (each
    leaf's step-1 gradient norm before the clip) and ``change``."""
    net = GraniteHybrid(model, semantics, matmul)
    stacked = {path: initial(path) for path in paths}
    p: Dict[str, object] = {}
    for path, w in stacked.items():
        w.requires_grad_(False)
        if path.split(".")[0] in STACKS.values():
            p[path] = [w[i].detach().requires_grad_() for i in range(len(w))]
        else:
            p[path] = w.detach().requires_grad_()
    m = {path: torch.zeros_like(w) for path, w in stacked.items()}
    v = {path: torch.zeros_like(w) for path, w in stacked.items()}
    out: dict = {"losses": []}
    b1, b2, eps = optim["beta1"], optim["beta2"], optim["eps"]
    for step, (tokens, labels) in enumerate(batches):
        per = tokens.shape[0] // splice
        total = 0.0
        for i in range(splice):
            rows = slice(i * per, (i + 1) * per)
            loss = net.loss(p, tokens[rows], labels[rows]) / splice
            loss.backward()
            total += float(loss.detach())
        out["losses"].append(total)
        with torch.no_grad():
            sq = {path: _leaf_sq(p[path], lambda t: t.grad) for path in p}
            gnorm = math.sqrt(sum(sq.values()))
            clip = min(1.0, optim["grad_clip"] / max(gnorm, 1e-9))
            if step == 0:
                out["grad1"] = {k: math.sqrt(x) for k, x in sq.items()}
            lr, c = lr_at(step, optim), step + 1
            bc1, bc2 = 1.0 - b1 ** c, 1.0 - b2 ** c
            for path in p:
                for j, x in enumerate(_layers(p[path])):
                    mj, vj = _at(m[path], j, p[path]), _at(v[path], j, p[path])
                    g = x.grad * clip
                    mj.mul_(b1).add_(g, alpha=1 - b1)
                    vj.mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (mj / bc1) / ((vj / bc2).sqrt() + eps)
                    x.sub_(lr * (upd + optim["weight_decay"] * x))
                    x.grad = None
    with torch.no_grad():
        out["change"] = {path: float(torch.linalg.vector_norm(
            stacked[path] - initial(path))) for path in paths}
    return out
