"""Architecture config registry: ``get_config(arch)`` / ``get_smoke(arch)``.

Port of ``repro/configs``: every config of the reference, in its
order — the paper's two serving backbones (Llama-2-7B and 13B),
the dense decoders (Phi-3-medium, Qwen2.5-3B with QKV bias, Nemotron-4-340B
with LayerNorm and a squared-ReLU MLP, SmolLM-360M), the two sparse-MoE
configs (Mixtral-8x22B, with its sliding window, and Grok-1), the two
stacks with recurrent state (RecurrentGemma-9B, hybrid RG-LRU + local
attention, and Mamba2-780M, attention-free SSD), PaliGemma-3B (a Gemma
decoder behind a prefix of image-patch embeddings) and the
encoder-decoder Whisper-medium (a bidirectional encoder over stub frame
embeddings, cross-attention in every decoder layer; ring caches only).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "recurrentgemma_9b",
    "phi3_medium_14b",
    "qwen2_5_3b",
    "nemotron_4_340b",
    "mixtral_8x22b",
    "grok_1_314b",
    "whisper_medium",
    "smollm_360m",
    "mamba2_780m",
    "paligemma_3b",
    # the paper's own evaluation models
    "llama2_7b",
    "llama2_13b",
]

# the dry run's --all set (the reference's ASSIGNED_ARCHS)
ASSIGNED_ARCHS = ARCH_IDS[:10]


def _norm(arch: str) -> str:
    return arch.replace("-", "_").replace(".", "_")


def _module(arch: str):
    name = _norm(arch)
    if name not in ARCH_IDS:
        raise KeyError(f"config {arch!r} is not ported; have {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
