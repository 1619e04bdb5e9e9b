"""The plain reference of a dense or MoE transformer's training step.

Plain PyTorch in f32, with TF32 off: the same mathematics as the
configuration states, written out with no kernel, no cache and nothing of
the program.  It takes the weights and batches the benchmark draws from
the seed and runs the job's first steps as the program's spliced step
defines them:

- a step runs the ``splice`` slices of the global batch in turn; each
  slice's loss is its mean cross entropy over its tokens plus, for MoE,
  ``router_aux_weight`` times the sum over layers of the Switch aux loss
  of the slice's own routing; the step's loss and gradient are the means
  over the slices;
- a layer is x + attn(norm(x)), then x + ffn(norm(x)); attention is
  causal, with split-half rotary embeddings and the KV heads repeated for
  GQA; the MLP is SwiGLU;
- an MoE layer routes each token of the slice to its top-k experts by an
  f32 softmax over the experts padded to a multiple of ``expert_pad``
  (padded ones never chosen; ties to the lower index), renormalises the
  k weights, and keeps an entry only where its slot, the running count of
  its expert over the token-major (token, choice) order, is below the
  capacity max(ceil(t k / E_padded cf), k);
- AdamW: the gradient clipped by its global norm, bias-corrected moments,
  decoupled weight decay on every leaf, the repo's warmup and cosine
  learning rate.

``matmul="fp8"`` is the control: every product's operands rounded to fp8
(e4m3 forward, e5m2 for the gradient flowing back), each tensor scaled by
its absolute maximum, as an fp8 training recipe does; the rest stays f32.

Memory: each layer and the loss run under a checkpoint, and the attention
of one sequence at a time under its own, so the largest buffers are one
sequence's (heads, S, S) scores and one chunk of logits.

The module also gives the family's parameter ``layout``.  It defines no
``DRAWS`` and no ``step_flops``: its leaves take ``weights.draw``'s
default rule, and its FLOPs are ``costs.step_flops``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CE_ROWS = 4096      # logits rows the loss holds at once
FP8 = {"e4m3": (torch.float8_e4m3fn, 448.0),
       "e5m2": (torch.float8_e5m2, 57344.0)}

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


def _fp8(x: torch.Tensor, fmt: str) -> torch.Tensor:
    """``x`` rounded to fp8 under a per-tensor scale, back in f32."""
    dtype, top = FP8[fmt]
    if x.numel() == 0:
        return x
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a, "e4m3"), _fp8(b, "e4m3")
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g, "e5m2")
        return torch.matmul(qg, qb.mT), torch.matmul(qa.mT, qg)


MATMULS: Dict[str, Callable] = {"f32": torch.matmul,
                                "fp8": _Fp8Matmul.apply}


class Transformer:
    """The model of a configuration's ``model`` block (the port's field
    names) and ``reference`` block (``expert_pad``, the norms' eps)."""

    def __init__(self, model: dict, semantics: dict, matmul: str = "f32"):
        self.m, self.sem, self.mm = model, semantics, MATMULS[matmul]
        self.d, self.h = model["d_model"], model["num_heads"]
        self.kvh = model["num_kv_heads"]
        self.hd = model.get("head_dim") or self.d // self.h

    # ------------------------------------------------------------ pieces
    def norm(self, x, p):
        if self.m["norm"] == "nonparametric_ln":
            mu = x.mean(-1, keepdim=True)
            var = (x - mu).square().mean(-1, keepdim=True)
            return (x - mu) * torch.rsqrt(var + self.sem["ln_eps"])
        var = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.sem["rms_eps"]) * p

    def rope(self, x):
        """x (r, S, heads, hd): the split-half rotation by position."""
        s, hd = x.shape[1], x.shape[-1]
        exponent = torch.arange(0, hd, 2, dtype=torch.float64,
                                device=x.device) / hd
        freqs = (1.0 / self.m.get("rope_theta", 10000.0) ** exponent).float()
        ang = torch.arange(s, device=x.device).float()[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x.chunk(2, dim=-1)
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _core(self, q, k, v):
        """One sequence's causal attention: q, k, v (S, H, hd)."""
        q, k, v = (t.transpose(0, 1) for t in (q, k, v))
        s = self.mm(q, k.mT) / math.sqrt(self.hd)
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
        q, k = self.rope(q), self.rope(k)
        rep = self.h // self.kvh
        k, v = (t.repeat_interleave(rep, dim=2) for t in (k, v))
        o = torch.stack([checkpoint(self._core, q[i], k[i], v[i],
                                    use_reentrant=False) for i in range(r)])
        return x + self.mm(o.reshape(r * s, -1),
                           wo.reshape(-1, d)).view(r, s, d)

    def mlp(self, x, ln, wi, wg, wo):
        r, s, d = x.shape
        h = self.norm(x, ln).reshape(r * s, d)
        y = self.mm(F.silu(self.mm(h, wg)) * self.mm(h, wi), wo)
        return x + y.view(r, s, d)

    def moe(self, x, ln, router, wi, wo, wg):
        """The expert layer: (x + out, the slice's Switch aux loss)."""
        cfg = self.m["moe"]
        r, s, d = x.shape
        t, e, k = r * s, cfg["num_experts"], cfg["top_k"]
        e_tot = e + (-e) % self.sem["expert_pad"]
        h = self.norm(x, ln).reshape(t, d)
        logits = self.mm(h, router)
        logits = torch.cat([logits, logits.new_full((t, e_tot - e), -1e30)],
                           -1)
        probs = torch.softmax(logits, dim=-1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[:, :k], idx[:, :k]
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
        top1 = F.one_hot(idx[:, 0], e_tot).float().mean(0)
        aux = e_tot * torch.sum(probs.mean(0) * top1)
        capacity = max(math.ceil(t * k / e_tot * cfg["capacity_factor"]), k)
        flat = idx.reshape(-1)
        slot = F.one_hot(flat, e_tot).cumsum(0).gather(1, flat[:, None])[:, 0] - 1
        kept = slot < capacity
        wflat = w.reshape(-1)
        # one slice a layer's backward stacks, not a full-size gradient of
        # the expert stack for every expert indexed
        wis, wgs, wos = wi.unbind(0), wg.unbind(0), wo.unbind(0)
        kept_at = torch.nonzero(kept)[:, 0]
        by_expert = kept_at[torch.argsort(flat[kept_at], stable=True)]
        counts = torch.bincount(flat[by_expert], minlength=e)[:e].tolist()
        toks, ys = [], []
        for j, entries in enumerate(by_expert.split(counts)):
            tok = entries // k
            xe = h[tok]
            ye = self.mm(F.silu(self.mm(xe, wgs[j])) * self.mm(xe, wis[j]),
                         wos[j])
            toks.append(tok)
            ys.append(ye * wflat[entries][:, None])
        out = torch.zeros_like(h).index_add(0, torch.cat(toks),
                                            torch.cat(ys))
        return x + out.view(r, s, d), aux

    def _ce_chunk(self, x, head, labels):
        lg = self.mm(x, head)
        return (torch.logsumexp(lg, -1)
                - lg.gather(1, labels[:, None])[:, 0]).sum()

    # ------------------------------------------------------------ a slice
    def loss(self, p: Dict[str, object], tokens, labels):
        """The slice's mean CE plus its weighted aux losses.  ``p`` maps
        each leaf's path to its tensor, and each stacked block leaf to the
        list of its layers."""
        r, s = tokens.shape
        x = p["embed"][tokens]
        aux = x.new_zeros(())
        for i in range(self.m["num_layers"]):
            def at(name, i=i):
                leaf = p.get(f"blocks.{name}")
                return None if leaf is None else leaf[i]
            x = checkpoint(self.attention, x, at("ln1.scale"), at("attn.wq"),
                           at("attn.wk"), at("attn.wv"), at("attn.wo"),
                           use_reentrant=False)
            if self.m.get("moe"):
                x, a = checkpoint(self.moe, x, at("ln2.scale"),
                                  at("moe.router"), at("moe.wi"),
                                  at("moe.wo"), at("moe.wg"),
                                  use_reentrant=False)
                aux = aux + a
            else:
                x = checkpoint(self.mlp, x, at("ln2.scale"), at("mlp.wi"),
                               at("mlp.wg"), at("mlp.wo"),
                               use_reentrant=False)
        x = self.norm(x, p.get("final_norm.scale")).reshape(r * s, -1)
        head = p["head"] if "head" in p else p["embed"].t()
        flat = labels.reshape(-1)
        ce = sum(checkpoint(self._ce_chunk, x[c:c + CE_ROWS], head,
                            flat[c:c + CE_ROWS], use_reentrant=False)
                 for c in range(0, r * s, CE_ROWS)) / (r * s)
        if self.m.get("moe"):
            return ce + self.m["moe"]["router_aux_weight"] * aux
        return ce


def lr_at(step: int, optim: dict) -> float:
    """The learning rate of step ``step`` (from 0): linear warmup over
    ``warmup_steps``, then a cosine from 1 to 0.1 of the peak at
    ``total_steps``."""
    warm = min((step + 1) / max(optim["warmup_steps"], 1), 1.0)
    prog = (step - optim["warmup_steps"]) / max(
        optim["total_steps"] - optim["warmup_steps"], 1)
    prog = min(max(prog, 0.0), 1.0)
    return optim["learning_rate"] * warm * (0.1 + 0.9 * 0.5 * (
        1.0 + math.cos(math.pi * prog)))


def train(model: dict, semantics: dict, optim: dict,
          initial: Callable[[str], torch.Tensor], paths: Sequence[str],
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]], splice: int,
          matmul: str = "f32") -> dict:
    """The first ``len(batches)`` steps of the job from ``initial(path)``
    (each leaf's f32 weights).  Returns the readings the program is
    compared on: ``losses`` (each step's loss, before its update),
    ``grad1`` (each leaf's norm of the step-1 gradient, before the
    clip) and ``change`` (each
    leaf's norm of its change over all the steps)."""
    net = Transformer(model, semantics, matmul)
    stacked = {path: initial(path) for path in paths}
    p: Dict[str, object] = {}
    for path, w in stacked.items():
        w.requires_grad_(False)
        if path.startswith("blocks."):
            p[path] = [w[i].detach().requires_grad_() for i in range(len(w))]
        else:
            p[path] = w.detach().requires_grad_()
    params = [t for v in p.values() for t in (v if isinstance(v, list) else [v])]
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


def _layers(leaf) -> List[torch.Tensor]:
    return leaf if isinstance(leaf, list) else [leaf]


def _at(stack: torch.Tensor, j: int, leaf) -> torch.Tensor:
    return stack[j] if isinstance(leaf, list) else stack


def _leaf_sq(leaf, get) -> float:
    return sum(float(torch.sum(get(x).double().square()))
               for x in _layers(leaf))
