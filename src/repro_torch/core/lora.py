"""LoRA parameter utilities (port of ``partition_lora`` from
``repro/core/lora.py``; the rest of that module is not ported yet)."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch


def _map(tree: Any, fn, in_lora: bool = False) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, in_lora or k == "lora")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, in_lora) for v in tree)
    return fn(tree, in_lora)


def partition_lora(params: Any) -> Tuple[Any, Any]:
    """Split into (backbone, adapters): leaves under a "lora" key go to the
    adapter tree, everything else to the backbone.  Both keep the full
    structure with None placeholders."""
    backbone = _map(params, lambda x, lo: None if lo else x)
    adapters = _map(params, lambda x, lo: x if lo else None)
    return backbone, adapters


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Non-None leaves in traversal order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]
