"""LoRA parameter management: partition, merge, multi-adapter stacking
(port of ``repro/core/lora.py``).

The paper's C1 requires *unmerged* inference — backbone weights stay
read-only and shared, LoRA deltas are applied as separate low-rank matmuls.
These utilities (a) split a parameter tree into the frozen backbone and
the adapters, (b) fold an adapter into a *copy* of the backbone (the
oracle for testing unmerged == merged), and (c) stack many adapters for
multi-LoRA serving with per-request adapter indices.

Trees are the port's: nested dicts and lists of tensors, with one dict per
layer in ``params["layers"]``; a bank leaf is (N, D, r) / (N, r, O), its
adapter axis third from last, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import ATTN, ModelConfig

Params = Dict[str, Any]


def _map(tree: Any, fn, in_lora: bool = False) -> Any:
    if isinstance(tree, dict):
        return {k: _map(v, fn, in_lora or k == "lora")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn, in_lora) for v in tree)
    return fn(tree, in_lora)


def _zip_map(fn: Callable, *trees: Any) -> Any:
    """Leafwise ``fn(*leaves)`` over trees of one structure (None leaves
    included)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_zip_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def partition_lora(params: Any) -> Tuple[Any, Any]:
    """Split into (backbone, adapters): leaves under a "lora" key go to the
    adapter tree, everything else to the backbone.  Both keep the full
    structure with None placeholders, so ``combine_lora`` recombines
    them."""
    backbone = _map(params, lambda x, lo: None if lo else x)
    adapters = _map(params, lambda x, lo: x if lo else None)
    return backbone, adapters


def combine_lora(backbone: Any, adapters: Any) -> Any:
    """Inverse of ``partition_lora``.  Backbone leaves are the SAME tensor
    objects, never copies."""
    return _zip_map(lambda b, a: b if b is not None else a, backbone,
                    adapters)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Non-None leaves in traversal order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def lora_param_count(params: Params) -> int:
    _, ad = partition_lora(params)
    return sum(x.numel() for x in tree_leaves(ad))


def backbone_param_count(params: Params) -> int:
    bb, _ = partition_lora(params)
    return sum(x.numel() for x in tree_leaves(bb))


# --------------------------------------------------------------------- merging
_TARGET_TO_W = {"q": "wq", "k": "wk", "v": "wv", "o": "wo"}


def merge_adapter(params: Params, cfg: ModelConfig,
                  adapter_idx: Optional[int] = None) -> Params:
    """Fold  W' = W + s·A·B  into a COPY of the backbone (testing oracle —
    serving never merges, per the paper's shared-backbone design).  If the
    tree holds a multi-adapter bank (..., N, D, r), ``adapter_idx`` selects
    one adapter."""
    s = cfg.lora.scaling

    def merge_attn(attn: Params) -> Params:
        if "lora" not in attn:
            return attn
        out = {k: v for k, v in attn.items() if k != "lora"}
        for tgt, lo in attn["lora"].items():
            a, b = lo["a"], lo["b"]
            wkey = _TARGET_TO_W[tgt]
            w = out[wkey]["w"]
            if adapter_idx is not None and a.dim() == w.dim() + 1:
                a = a.select(-3, adapter_idx)
                b = b.select(-3, adapter_idx)
            if a.dim() != w.dim():
                raise ValueError(
                    f"adapter rank mismatch for {tgt}: {tuple(a.shape)} vs "
                    f"{tuple(w.shape)} (multi-adapter bank needs "
                    f"adapter_idx)")
            delta = s * (a.float() @ b.float())
            out[wkey] = dict(out[wkey])
            out[wkey]["w"] = (w.float() + delta).to(w.dtype)
        return out

    def walk(tree):
        if isinstance(tree, dict):
            if "wq" in tree and "wo" in tree:      # attention param group
                return merge_attn(tree)
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return tree

    return walk(params)


# --------------------------------------------------------- multi-LoRA stacking
def stack_adapters(adapter_trees: List[Any]) -> Any:
    """Stack N single-adapter trees (leaves (D, r) / (r, O)) into a
    multi-LoRA tree with a leading adapter axis (N, D, r) / (N, r, O)."""
    return _zip_map(
        lambda *xs: None if xs[0] is None else torch.stack(xs),
        *adapter_trees)


def select_adapter(adapters: Any, i: int) -> Any:
    """Adapter i of a tree built by ``stack_adapters`` (axis 0)."""
    return _map(adapters, lambda x, _: None if x is None else x[i])


def take_adapter(adapters: Any, i: int) -> Any:
    """Adapter i of a stacked bank along the ADAPTER axis (-3), the axis
    ``merge_adapter`` folds over; its leaves are single-adapter (D, r) /
    (r, O) views, which ``layers.dense`` applies without ``adapter_idx``."""
    return _map(adapters,
                lambda x, _: None if x is None else x.select(-3, i))


def bank_size(adapters: Any) -> int:
    """Capacity N of a stacked adapter bank (size of the adapter axis)."""
    for leaf in tree_leaves(adapters):
        return int(leaf.shape[-3])
    raise ValueError("empty adapter tree")


def init_adapter_bank(generator: torch.Generator, cfg: ModelConfig,
                      num_adapters: int, *, device="cuda",
                      lora_b_scale: float = 0.0) -> Any:
    """Fresh multi-LoRA bank of ``num_adapters`` adapters: A ~ N(0, 1/d_in)
    and, by default, B = 0 (the reference's LoRA init).  ``generator``
    must live on ``device``."""
    from repro_torch.models.transformer import init_params
    multi = init_params(cfg, generator, device, lora_adapters=num_adapters,
                        lora_b_scale=lora_b_scale)
    _, adapters = partition_lora(multi)
    return adapters


def adapter_bytes(cfg: ModelConfig) -> int:
    """Per-adapter artifact size (bytes) for the serverless artifact
    model."""
    r = cfg.lora.rank
    D, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    sizes = {"q": (D + H * hd), "k": (D + K * hd), "v": (D + K * hd),
             "o": (H * hd + D)}
    per_layer = sum(sizes[t] * r for t in cfg.lora.targets if t in sizes)
    n_attn = sum(1 for k in cfg.layer_kinds if k == ATTN)
    itemsize = torch.finfo(cfg.torch_dtype).bits // 8
    return int(per_layer * max(n_attn, cfg.num_layers // 2) * itemsize)

