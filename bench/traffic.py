"""The one generator of the benchmark's traffic, driven by a data file.

A traffic file (``bench/traffic/<name>.json``) gives the job's shape: the
sequence length, the global batch in sequences, the logical world and the
physical devices it is mapped onto, and the law of the token ids.  The
tokens are drawn on the device from ``--seed``: each step's batch from a
generator of its own, so that step ``i``'s batch is the same whichever
steps ran before it, and the reference can draw the first ones again.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path

import torch

KEYS = ("seq_len", "global_batch", "world", "physical", "zipf_exponent")


def load(path: Path) -> dict:
    """A traffic file, checked for its keys."""
    spec = json.loads(Path(path).read_text())
    missing = [k for k in KEYS if k not in spec]
    if missing:
        raise ValueError(f"{path}: traffic keys missing: {missing}")
    if spec["global_batch"] % spec["world"] or spec["world"] % spec["physical"]:
        raise ValueError(f"{path}: the batch, world and physical devices "
                         f"do not divide")
    return spec


def mix(seed: int, tag: str) -> int:
    """A 63-bit generator seed from the run's seed and a tag."""
    digest = hashlib.blake2b(f"{seed}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class ZipfTokens:
    """Token ids over a vocabulary of ``vocab``: rank r (from 0) is drawn
    with probability proportional to (r + 1) ** -exponent, and the ranks
    are given to the ids by a permutation drawn from the seed, so the
    frequent ids are spread over the table.  Every row is one packed
    stream of ``seq_len + 1`` ids, with no padding; inputs and labels are
    its two shifts."""

    def __init__(self, spec: dict, vocab: int, seed: int, device):
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64,
                             device=self.device)
        cdf = torch.cumsum(ranks.pow(-float(spec["zipf_exponent"])), 0)
        self.cdf = cdf / cdf[-1]
        gen = torch.Generator(device=self.device).manual_seed(
            mix(seed, "vocab"))
        self.ids = torch.randperm(vocab, generator=gen, device=self.device)

    def batch(self, step: int):
        """(tokens, labels) of step ``step``, each (global batch, seq_len)
        int64 on the device."""
        gen = torch.Generator(device=self.device).manual_seed(
            mix(self.seed, f"batch{step}"))
        shape = (self.spec["global_batch"], self.spec["seq_len"] + 1)
        u = torch.rand(shape, generator=gen, dtype=torch.float64,
                       device=self.device)
        rank = torch.searchsorted(self.cdf, u).clamp_(max=len(self.ids) - 1)
        rows = self.ids[rank]
        return rows[:, :-1], rows[:, 1:]


class Feed:
    """What the runtime's data pipeline gives it, from a ``ZipfTokens``:
    ``next_batch()`` and a ``snapshot()`` of its cursor."""

    def __init__(self, tokens: ZipfTokens):
        self.tokens, self.step = tokens, 0

    def next_batch(self):
        out = self.tokens.batch(self.step)
        self.step += 1
        return out

    def snapshot(self) -> dict:
        return {"seed": self.tokens.seed, "step": self.step}
