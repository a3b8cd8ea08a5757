"""Model configuration (port of ``repro/models/config.py``).

The same frozen dataclass as the reference, field for field, so a config
reads the same in both packages.  ``jnp_dtype`` becomes ``torch_dtype``.
Only the attention-only dense stack (Llama-2) is served by the port so
far; the other families' fields are kept so configs stay comparable.
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

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Backbone parameter count of an attention-only stack."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, K, hd = self.num_heads, self.num_kv_heads, self.head_dim_
        attn = D * H * hd + 2 * D * K * hd + H * hd * D
        if self.qkv_bias:
            attn += (H + 2 * K) * hd
        mlp = 3 * D * F if self.mlp_for == SWIGLU else 2 * D * F
        total = (attn + mlp) * self.num_layers + V * D + D
        if not self.tie_embeddings:
            total += V * D
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (equal to ``param_count`` without
        experts, the only case the port serves)."""
        return self.param_count()
