"""Architecture config registry: ``get_config(arch)`` / ``get_smoke(arch)``.

Port of ``repro/configs``.  Ported so far: the paper's primary serving
backbone, Llama-2-7B, the two sparse-MoE configs (Mixtral-8x22B, with
its sliding window, and Grok-1), and the two stacks with recurrent
state (RecurrentGemma-9B, hybrid RG-LRU + local attention, and
Mamba2-780M, attention-free SSD); the other configs follow with the model
families they need.
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["recurrentgemma_9b", "mixtral_8x22b", "grok_1_314b",
                       "mamba2_780m", "llama2_7b"]


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
