"""Batched serving engine: prefill + decode over the port's model API (port
of ``repro.serving.engine``).

Two halves live here:

* ``ServingEngine`` — the decode loop in PyTorch on one device.  The
  prefill attention runs through the hand-written CUDA kernel on a card.
* The analytic batching/latency model (``GpuSpec``, ``decode_step_seconds``,
  ``max_batch_for_slo``, ``ReplicaProfile``), a copy of the JAX package's
  pure-Python decode roofline.  Its default ``GpuSpec`` is the H100 SXM's
  data sheet; the TPU defaults of the JAX package do not carry over.

The roofline is the standard decode-step model: per step a replica streams
the (sharded) weights plus the batch's KV cache from HBM and performs
``2 * active_params * batch`` FLOPs, so

    step = max(bytes_moved / (g * hbm_bw), flops / (g * peak * mfu)) + overhead

with ``g`` the tensor-parallel degree.  p99 is a fixed multiplier over the
mean step (queueing + stragglers).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import constants, resolve_device, torch_dtype

BYTES_PER_PARAM = 2  # bf16 weights and KV cache


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """Per-accelerator envelope the decode roofline runs against.

    The memory and peak figures are the H100 SXM data sheet's.  ``mfu`` and
    ``step_overhead_seconds`` are modelling assumptions, not measurements.
    """

    name: str = "h100-sxm"
    hbm_bytes: int = int(constants.DATASHEET_HBM_BYTES)
    hbm_bandwidth: float = constants.DATASHEET_HBM_BANDWIDTH
    flops: float = constants.DATASHEET_PEAK_BF16_FLOPS
    # achievable fraction of peak during decode (small-batch GEMMs).
    mfu: float = 0.4
    # dispatch + collective latency per decode step, seconds.
    step_overhead_seconds: float = 3e-4


DEFAULT_GPU = GpuSpec()


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters touched per decode step (MoE routes ``top_k`` experts)."""
    total = cfg.param_count()
    if cfg.moe is None:
        return total
    mult = 3 if cfg.mlp == "swiglu" else 2
    expert = cfg.num_layers * mult * cfg.d_model * cfg.d_ff * cfg.moe.num_experts
    expert = min(expert, total)
    active = total - expert + expert * cfg.moe.top_k / cfg.moe.num_experts
    return int(active)


def kv_bytes_per_token(cfg: ModelConfig) -> int:
    """KV-cache bytes appended per generated token (all layers, K + V)."""
    if not cfg.num_heads:  # pure-SSM: constant state, charge nothing per token
        return 0
    hd = cfg.resolved_head_dim()
    return 2 * cfg.num_layers * cfg.num_kv_heads * hd * BYTES_PER_PARAM


def weight_bytes(cfg: ModelConfig) -> int:
    return cfg.param_count() * BYTES_PER_PARAM


def min_gpus_for_memory(
    cfg: ModelConfig,
    gpu: GpuSpec = DEFAULT_GPU,
    memory_overhead: float = 1.25,
) -> int:
    """Smallest power-of-two shard degree whose HBM fits the weights.

    ``memory_overhead`` reserves headroom for KV cache and activations.
    """
    need = weight_bytes(cfg) * memory_overhead
    g = 1
    while g * gpu.hbm_bytes < need:
        g *= 2
    return g


def decode_step_seconds(
    cfg: ModelConfig,
    batch: int,
    n_gpus: int,
    gpu: GpuSpec = DEFAULT_GPU,
    context_len: int = 1024,
) -> float:
    """Mean decode-step latency for one replica sharded over ``n_gpus``."""
    moved = weight_bytes(cfg) + batch * context_len * kv_bytes_per_token(cfg)
    mem = moved / n_gpus / gpu.hbm_bandwidth
    comp = 2.0 * active_param_count(cfg) * batch / n_gpus / (gpu.flops * gpu.mfu)
    return max(mem, comp) + gpu.step_overhead_seconds


def max_batch_for_slo(
    cfg: ModelConfig,
    slo_seconds: float,
    n_gpus: int,
    gpu: GpuSpec = DEFAULT_GPU,
    p99_factor: float = 1.4,
    context_len: int = 1024,
    max_batch: int = 256,
) -> int:
    """Largest batch whose p99 decode step stays within the SLO (0 = none).

    Step latency is monotone nondecreasing in batch, so binary search.
    """
    if decode_step_seconds(cfg, 1, n_gpus, gpu, context_len) * p99_factor > (
        slo_seconds
    ):
        return 0
    lo, hi = 1, max_batch
    while lo < hi:
        mid = (lo + hi + 1) // 2
        p99 = decode_step_seconds(cfg, mid, n_gpus, gpu, context_len) * p99_factor
        if p99 <= slo_seconds:
            lo = mid
        else:
            hi = mid - 1
    return lo


@dataclasses.dataclass(frozen=True)
class ReplicaProfile:
    """One replica group's operating point: the qps -> replicas curve."""

    name: str
    gpus_per_replica: int
    batch: int
    p99_decode_seconds: float
    tokens_per_second: float
    qps_per_replica: float
    weight_bytes: int

    @classmethod
    def from_config(
        cls,
        cfg: ModelConfig,
        slo_ms: float,
        tokens_per_request: int = 128,
        gpu: GpuSpec = DEFAULT_GPU,
        p99_factor: float = 1.4,
        context_len: int = 1024,
        max_gpus: int = 256,
    ) -> "ReplicaProfile":
        """Pick the smallest power-of-two shard degree meeting the SLO."""
        slo = slo_ms / 1e3
        g = min_gpus_for_memory(cfg, gpu)
        batch = 0
        while g <= max_gpus:
            batch = max_batch_for_slo(cfg, slo, g, gpu, p99_factor, context_len)
            if batch > 0:
                break
            g *= 2
        if batch == 0:
            raise ValueError(
                f"{cfg.name}: p99 {slo_ms}ms unreachable within "
                f"{max_gpus} gpus/replica"
            )
        step = decode_step_seconds(cfg, batch, g, gpu, context_len)
        tps = batch / step
        return cls(
            name=cfg.name,
            gpus_per_replica=g,
            batch=batch,
            p99_decode_seconds=step * p99_factor,
            tokens_per_second=tps,
            qps_per_replica=tps / tokens_per_request,
            weight_bytes=weight_bytes(cfg),
        )

    def replicas_for(self, qps: float, utilization: float = 1.0) -> int:
        """Replicas needed to serve ``qps`` at the given target utilization."""
        if qps <= 0.0:
            return 0
        return int(math.ceil(qps / (self.qps_per_replica * utilization)))


class ServingEngine:
    """Greedy or sampled generation for one model on one device.

    ``params``, when given, is a tree of tensors on ``device`` (see
    ``bridge.params_from_jax``); else weights are drawn from ``seed``
    directly in the config's compute dtype, which holds the values the JAX
    engine's f32 weights take at each use.  The audio and VLM families'
    frame/patch embeddings are drawn from ``seed + 7``, as the JAX engine's
    are (with torch's generator, so not the same values).  The model code
    is imported here, not with the module, so that the analytic half above
    (and the scheduler's serving tier, which reads ``ReplicaProfile``)
    loads without it.
    """

    def __init__(self, cfg: ModelConfig, seed: int = 0,
                 params: Optional[dict] = None, device="cuda"):
        from repro_torch.models import (
            decode_step_fn, init_params, prefill_fn)
        from repro_torch.models.frontend import synth_extra_inputs

        self._prefill_fn = prefill_fn
        self._decode_step_fn = decode_step_fn
        self._synth_extra_inputs = synth_extra_inputs
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params if params is not None else init_params(
            cfg, seed, device=self.device, dtype=torch_dtype(cfg.dtype))
        self._extra_seed = seed + 7

    @torch.inference_mode()
    def generate(self, prompts, max_new_tokens: int, temperature: float = 0.0,
                 seed: int = 0) -> torch.Tensor:
        """prompts: (B, S) ints -> generated (B, max_new_tokens) int32."""
        prompts = torch.as_tensor(prompts, device=self.device)
        batch = {"tokens": prompts,
                 **self._synth_extra_inputs(self.cfg, prompts.shape[0],
                                            self._extra_seed,
                                            device=self.device)}
        logits, state = self._prefill_fn(
            self.params, batch, self.cfg,
            cache_len=prompts.shape[1] + max_new_tokens)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        tok = self._sample(logits, temperature, gen)
        out = [tok]
        for _ in range(max_new_tokens - 1):
            logits, state = self._decode_step_fn(self.params, state, tok,
                                                 self.cfg)
            tok = self._sample(logits, temperature, gen)
            out.append(tok)
        return torch.stack(out, dim=1)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
        """Greedy at temperature <= 0, else a draw from softmax(logits / T).
        The draws are not ``jax.random.categorical``'s."""
        if temperature <= 0.0:
            return logits.argmax(dim=-1).to(torch.int32)
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
