"""Configuration dataclasses for the PyTorch port.

A copy of ``repro.configs.base`` that the port keeps as its own, so that
``repro_torch`` imports nothing of the JAX package.  Every assigned
architecture is expressed as a ``ModelConfig`` (plus optional MoE / SSM /
enc-dec / VLM sub-configs).  Input shapes are ``ShapeConfig``.  All configs
are plain frozen dataclasses so they hash, compare and print cleanly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # capacity factor for expert-parallel dispatch (tokens per expert buffer).
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # shared (always-on) expert FFN width; 0 = none.
    shared_expert_ff: int = 0


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block configuration (arXiv:2405.21060)."""
    state_dim: int = 128          # N, SSM state size
    head_dim: int = 64            # P, channels per SSD head
    expand: int = 2               # d_inner = expand * d_model
    chunk_size: int = 128         # SSD chunked-scan block length
    conv_width: int = 4           # depthwise causal conv width


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (whisper-style) backbone.  Frontend is a stub."""
    encoder_layers: int = 6
    encoder_seq: int = 1500       # whisper-base: 30s audio -> 1500 frames
    cross_attention: bool = True


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """VLM cross-attention configuration (llama-3.2-vision style)."""
    cross_attn_every: int = 5     # a cross-attn layer every k layers
    num_image_tokens: int = 1601  # stubbed vision-encoder output tokens
    image_embed_dim: int = 1280   # stubbed vision embedding width (pre-projector)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                # dense|moe|ssm|hybrid|audio|vlm|interleaved
    num_layers: int
    d_model: int
    num_heads: int                # query heads (0 for attention-free)
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    # attention
    sliding_window: int = 0       # 0 = full causal attention
    rope_theta: float = 10000.0
    # normalization: "rmsnorm" | "nonparametric_ln" (olmo) | "layernorm"
    norm: str = "rmsnorm"
    # mlp: "swiglu" | "gelu"
    mlp: str = "swiglu"
    tie_embeddings: bool = False
    # hybrid: attention block every k layers (zamba2-style shared block); 0 = n/a
    attn_every: int = 0
    shared_attn_block: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    max_seq_len: int = 1 << 20
    dtype: str = "bfloat16"
    source: str = ""              # citation
    # The port's own fields (the JAX package has none of them).  At their
    # defaults every family runs as it does without them.
    # interleaved: the mixer of each layer, "mamba" or "attention"
    layer_types: Tuple[str, ...] = ()
    # granite's multipliers (dense, moe and interleaved training): the
    # embedding's output times embedding_multiplier; attention_multiplier
    # as the softmax scale (0 = 1/sqrt(head_dim)); each residual branch
    # times residual_multiplier; the final norm's output over
    # logits_scaling before the head
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    # the eps of every RMSNorm, the Mamba2 mixer's gated one included
    norm_eps: float = 1e-6

    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        assert self.num_heads > 0
        return self.d_model // self.num_heads

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        total = v * d                      # embed
        if not self.tie_embeddings:
            total += v * d                 # lm head
        hd = self.resolved_head_dim() if self.num_heads else 0

        def attn_params() -> int:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o

        def mlp_params(ff: int) -> int:
            mult = 3 if self.mlp == "swiglu" else 2
            return mult * d * ff

        def ssm_params() -> int:
            s = self.ssm
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            in_proj = d * (2 * d_in + 2 * s.state_dim + nheads)
            conv = s.conv_width * (d_in + 2 * s.state_dim)
            out = d_in * d
            return in_proj + conv + out + 2 * nheads  # + A_log, D

        per_layer = 0
        if self.arch_type in ("dense", "audio", "vlm"):
            per_layer = attn_params() + mlp_params(self.d_ff)
        elif self.arch_type == "moe":
            m = self.moe
            expert = mlp_params(self.d_ff) * m.num_experts
            router = d * m.num_experts
            shared = mlp_params(m.shared_expert_ff) if m.shared_expert_ff else 0
            per_layer = attn_params() + expert + router + shared
        elif self.arch_type == "ssm":
            per_layer = ssm_params()
        elif self.arch_type == "hybrid":
            per_layer = ssm_params() + mlp_params(self.d_ff) // self.num_layers
        total += per_layer * self.num_layers
        if self.arch_type == "hybrid":
            # one shared attention block (zamba2-style)
            total += attn_params() + mlp_params(self.d_ff)
        if self.arch_type == "vlm":
            n_cross = self.num_layers // self.vlm.cross_attn_every
            total += n_cross * attn_params()
            total += self.vlm.image_embed_dim * d  # projector
        if self.arch_type == "audio":
            e = self.encdec
            total += e.encoder_layers * (attn_params() + mlp_params(self.d_ff))
            total += self.num_layers * attn_params()  # decoder cross-attn
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of experts)."""
        if self.arch_type != "moe":
            return self.param_count()
        m = self.moe
        d = self.d_model
        mult = 3 if self.mlp == "swiglu" else 2
        expert_all = mult * d * self.d_ff * m.num_experts * self.num_layers
        expert_active = mult * d * self.d_ff * m.top_k * self.num_layers
        return self.param_count() - expert_all + expert_active


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeConfig:
    for s in INPUT_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown input shape {name!r}; have {[s.name for s in INPUT_SHAPES]}")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    zero_shard_factor: int = 1    # ZeRO partial-sharding factor (paper §5.4)
    remat: bool = True
    remat_policy: str = "full"    # "full" | "dots" (save matmul outputs)
    seed: int = 0


def reduced(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
            n_heads: int = 4, max_experts: int = 4, vocab: int = 512,
            d_ff: int = 0) -> ModelConfig:
    """Build a reduced smoke-test variant of the same architecture family."""
    kv = max(1, min(cfg.num_kv_heads, n_heads) if cfg.num_kv_heads else 0)
    if cfg.num_kv_heads and cfg.num_heads:
        # preserve GQA ratio where possible
        ratio = max(1, cfg.num_heads // cfg.num_kv_heads)
        kv = max(1, n_heads // ratio)
    changes = dict(
        num_layers=layers,
        d_model=d_model,
        num_heads=n_heads if cfg.num_heads else 0,
        num_kv_heads=kv if cfg.num_kv_heads else 0,
        d_ff=d_ff or (d_model * 4 if cfg.d_ff else 0),
        vocab_size=vocab,
        head_dim=0,
        sliding_window=min(cfg.sliding_window, 128) if cfg.sliding_window else 0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
    )
    if cfg.moe is not None:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=min(cfg.moe.num_experts, max_experts),
            top_k=min(cfg.moe.top_k, 2),
            shared_expert_ff=min(cfg.moe.shared_expert_ff, d_model) if cfg.moe.shared_expert_ff else 0)
    if cfg.ssm is not None:
        changes["ssm"] = dataclasses.replace(
            cfg.ssm, state_dim=min(cfg.ssm.state_dim, 16), head_dim=32,
            chunk_size=32)
    if cfg.encdec is not None:
        changes["encdec"] = dataclasses.replace(
            cfg.encdec, encoder_layers=2, encoder_seq=64)
    if cfg.vlm is not None:
        changes["vlm"] = dataclasses.replace(
            cfg.vlm, cross_attn_every=2, num_image_tokens=16, image_embed_dim=64)
    return dataclasses.replace(cfg, **changes)
