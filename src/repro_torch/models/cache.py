"""KV caches for attention-only stacks (port of the attention subset of
``repro/models/cache.py``): ring caches for the warm-function engine and
paged pools for the serving runtime.

Ring cache (``init_cache``): per layer ``{"k","v": (B, S, K, hd),
"slot_pos": (S,) int32 (-1 = empty), "idx"}``.  Token t of a row is
written at slot ``idx % S`` and ``slot_pos`` records its absolute
position; ``idx`` counts tokens written.  ``idx`` is a host ``int``: the
port runs eagerly, and keeping the counter on the host spares a device
sync per step.  S is ``min(context_len, sliding_window)`` for windowed
configs.

Paged pools: the per-layer cache is a pool of fixed-size blocks shared by every decode
slot.  A host-side block table (B, max_blocks) int32 maps each slot's
logical block j (token positions [j*bs, (j+1)*bs)) to a physical block
id; -1 marks unallocated entries and blocks reclaimed after they slid out of
a sliding window.  Physical block 0 is reserved as a
*garbage* block: writes from inactive/stalled slots (table entry -1) are
clipped onto it and never read back, which keeps every decode step
branch-free and fixed-shape.

Unlike the reference, whose jitted steps return new caches (donated
buffers), the port updates both kinds IN PLACE — the stand-in for
``donate_argnums``.  Either cache is a list with one dict per layer, in
stack order (not the reference's ``{"periods", "tail"}`` tree).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.models.config import ATTN, REC, SSD, ModelConfig

Cache = List[Dict[str, Any]]

GARBAGE_BLOCK = 0


def attn_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype, device) -> Dict[str, Any]:
    """One attention layer's ring cache."""
    K, hd = cfg.num_kv_heads, cfg.head_dim_
    shape = (batch, cache_len, K, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                   device=device),
            "idx": 0}


def effective_cache_len(cfg: ModelConfig, context_len: int) -> int:
    """Physical ring length: bounded by the sliding window."""
    if cfg.sliding_window is not None:
        return min(context_len, cfg.sliding_window)
    return context_len


def init_cache(cfg: ModelConfig, batch: int, context_len: int,
               dtype: Optional[torch.dtype] = None, *,
               device="cuda") -> Cache:
    """Full-model ring cache: one per attention layer (attention-only
    stacks; the reference's REC/SSD and cross-attention caches are not
    ported)."""
    if any(kind != ATTN for kind in cfg.layer_kinds) or \
            cfg.cross_attention or cfg.encoder_layers:
        raise ValueError(f"{cfg.name}: ring caches are ported for "
                         f"attention-only decoder stacks")
    dtype = dtype or cfg.torch_dtype
    clen = effective_cache_len(cfg, context_len)
    return [attn_cache(cfg, batch, clen, dtype, device)
            for _ in cfg.layer_kinds]


def paged_attn_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype: torch.dtype, device) -> Dict[str, torch.Tensor]:
    """One attention layer's block pool: {"kp","vp"}: (K, NB, bs, hd).

    Heads-major so the kernels' per-block tile is one contiguous
    (block_size, hd) slab."""
    K, hd = cfg.num_kv_heads, cfg.head_dim_
    shape = (K, num_blocks, block_size, hd)
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def has_slot_state(cfg: ModelConfig) -> bool:
    """True if the stack contains REC/SSD layers (per-slot state rows)."""
    kinds = set(cfg.pattern) | set(cfg.remainder_layers)
    return bool(kinds & {REC, SSD})


def paging_unsupported_reason(cfg: ModelConfig) -> Optional[str]:
    """None if the port's paged runtime can serve the config.

    The reference also serves hybrid REC/SSD stacks through per-slot state
    rows; the port does not carry those rows yet, so such stacks are
    refused here with that reason, as are encoder/cross-attention models
    (refused by the reference too)."""
    if cfg.cross_attention or cfg.encoder_layers:
        return "paged serving does not support encoder/cross-attention models"
    if has_slot_state(cfg):
        return ("REC/SSD slot-state serving is not ported to the PyTorch "
                "runtime yet")
    return None


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype: Optional[torch.dtype] = None, *,
                     device="cuda") -> Cache:
    """Full-model paged cache: one block pool per attention layer."""
    reason = paging_unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(reason)
    dtype = dtype or cfg.torch_dtype
    assert all(kind == ATTN for kind in cfg.layer_kinds)
    return [paged_attn_cache(cfg, num_blocks, block_size, dtype, device)
            for _ in cfg.layer_kinds]
