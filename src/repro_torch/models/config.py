"""Model configuration (port of ``repro/models/config.py``).

The same frozen dataclass as the reference, field for field, so a config
reads the same in both packages.  ``jnp_dtype`` becomes ``torch_dtype``.
The port serves decoder stacks of attention (dense Llama-2, sparse MoE
Mixtral and Grok), RG-LRU recurrent blocks (RecurrentGemma) and SSD
blocks (Mamba-2), a decoder behind an image prefix (PaliGemma) and the
encoder-decoder Whisper (``encoder_layers``, ``encoder_seq``,
``cross_attention``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# Mixer kinds
ATTN = "attn"          # GQA attention (optional sliding window / bias)
REC = "rec"            # RG-LRU recurrent block (griffin/recurrentgemma)
SSD = "ssd"            # Mamba-2 state-space duality block (attention-free)

# MLP kinds
SWIGLU = "swiglu"
SQRELU = "squared_relu"
GELU = "gelu"
MOE = "moe"
NONE = "none"          # SSD blocks carry their own in/out projections


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    """Low-rank adapter attached to backbone projections."""
    rank: int = 16
    alpha: float = 32.0
    targets: Tuple[str, ...] = ("q", "k", "v", "o")
    # number of distinct adapters served by a multi-LoRA engine
    num_adapters: int = 1

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: Optional[int] = None   # default d_model // num_heads
    mlp_type: str = SWIGLU
    qkv_bias: bool = False
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm
    tie_embeddings: bool = True
    rope_theta: float = 10_000.0

    sliding_window: Optional[int] = None
    long_context_window: int = 4096

    num_experts: int = 0
    experts_per_token: int = 0

    ssm_state_dim: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    ssm_conv_width: int = 4

    layer_pattern: Tuple[str, ...] = ()

    encoder_layers: int = 0
    encoder_seq: int = 0
    cross_attention: bool = False

    num_image_tokens: int = 0

    dtype: str = "bfloat16"
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)

    source: str = ""

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern:
            return self.layer_pattern
        if self.family == "ssm":
            return (SSD,)
        return (ATTN,)

    @property
    def mlp_for(self) -> str:
        if self.family == "moe":
            return MOE
        if self.family == "ssm":
            return NONE
        return self.mlp_type

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def num_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def remainder_layers(self) -> Tuple[str, ...]:
        p = self.pattern
        return p[: self.num_layers - self.num_periods * len(p)]

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Mixer kind of every layer in stack order (periods, then tail)."""
        return self.pattern * self.num_periods + self.remainder_layers

    @property
    def is_subquadratic(self) -> bool:
        """True if decode memory/compute does not grow with full context."""
        return self.family in ("ssm", "hybrid") or \
            self.sliding_window is not None

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Backbone parameter count, as the reference counts it: ATTN
        layers with their MLP, REC blocks (in/gate projections, gates'
        biases, Λ, out projection) with their MLP, SSD blocks alone; an
        encoder's layers (attention and a GELU MLP) and each decoder
        layer's cross-attention projections (norms not counted)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, K, hd = self.num_heads, self.num_kv_heads, self.head_dim_
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        if self.qkv_bias:
            attn += (H + 2 * K) * hd
        if self.mlp_for == MOE:
            mlp = self.num_experts * (2 * D * F + F * D) + D * self.num_experts
        elif self.mlp_for == SWIGLU:
            mlp = 3 * D * F
        elif self.mlp_for == NONE:
            mlp = 0
        else:
            mlp = 2 * D * F
        Di, S, nh = self.d_inner, self.ssm_state_dim, self.ssm_num_heads
        per = {ATTN: attn + mlp,
               REC: 2 * D * Di + 2 * Di + Di * D + 2 * Di + mlp,
               SSD: D * (2 * Di + 2 * S + nh) + Di * D + nh * 2 + Di}
        total = sum(per[k] for k in self.layer_kinds) + V * D + D
        if not self.tie_embeddings:
            total += V * D
        if self.encoder_layers:
            total += self.encoder_layers * (attn + 2 * D * F)
            if self.cross_attention:
                total += self.num_layers * attn
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.mlp_for != MOE:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        dead = (self.num_experts - self.experts_per_token) * 3 * D * F
        return int(self.param_count() - dead * self.num_layers)
