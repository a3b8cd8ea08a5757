"""Decode caches (port of ``repro/models/cache.py``): ring caches of
decoder stacks for the warm-function engine, and for the serving runtime
paged pools beside per-slot REC/SSD state rows.

Ring cache (``init_cache``): per ATTN layer ``{"k","v": (B, S, K, hd),
"slot_pos": (S,) int32 (-1 = empty), "idx"}``.  Token t of a row is
written at slot ``idx % S`` and ``slot_pos`` records its absolute
position; ``idx`` counts tokens written.  ``idx`` is a host ``int``: the
port runs eagerly, and keeping the counter on the host spares a device
sync per step.  S is ``min(context_len, sliding_window)`` for windowed
configs.  A REC layer holds ``{"conv": (B, W-1, Di), "h": (B, Di)
float32, "idx"}`` and an SSD layer ``{"conv", "ssm": (B, nh, hd, S)
float32, "idx"}`` (the reference's ``rec_cache`` / ``ssd_cache``, plus
the port's token counter, which marks every layer of a ring cache).  A
cross-attention model's ATTN layer also holds the encoder's K/V, ``"xk",
"xv": (B, encoder_seq, K, hd)``, written once at prefill, and ``"xpos":
(encoder_seq,) int32`` = ``[0, encoder_seq)``, the constant slot
positions the ring-decode kernel reads them by.

Paged pools: the per-layer cache is a pool of fixed-size blocks shared by every decode
slot.  A host-side block table (B, max_blocks) int32 maps each slot's
logical block j (token positions [j*bs, (j+1)*bs)) to a physical block
id; -1 marks unallocated entries and blocks reclaimed after they slid out of
a sliding window.  Physical block 0 is reserved as a
*garbage* block: writes from inactive/stalled slots (table entry -1) are
clipped onto it and never read back, which keeps every decode step
branch-free and fixed-shape.

Slot state: REC/SSD layers have no per-position K/V to page; their
decode state is a fixed-size recurrent summary of the whole prefix (conv
tail + hidden / SSM state).  The paged cache therefore holds, per such
layer, dense ``(num_slots + 1, ...)`` state tensors beside the pools —
one row per decode slot plus a reserved *garbage row* (the last one, index
``num_slots``) that plays the role of the garbage block: prefill padding
rows and stalled decode rows are pointed at it, so their discarded
computation never advances a live slot's state.  It is never read as real
state.

Unlike the reference, whose jitted steps return new caches (donated
buffers), the port updates every kind IN PLACE — the stand-in for
``donate_argnums``.  Either cache is a list with one dict per layer, in
stack order (not the reference's ``{"periods", "tail"}`` tree).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import ATTN, REC, SSD, ModelConfig

Cache = List[Dict[str, Any]]

GARBAGE_BLOCK = 0


def attn_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype, device, *,
               cross: bool = False) -> Dict[str, Any]:
    """One attention layer's ring cache; with ``cross`` also the zero
    encoder K/V and their constant slot positions."""
    K, hd = cfg.num_kv_heads, cfg.head_dim_
    shape = (batch, cache_len, K, hd)
    c = {"k": torch.zeros(shape, dtype=dtype, device=device),
         "v": torch.zeros(shape, dtype=dtype, device=device),
         "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                                device=device),
         "idx": 0}
    if cross:
        xshape = (batch, cfg.encoder_seq, K, hd)
        c["xk"] = torch.zeros(xshape, dtype=dtype, device=device)
        c["xv"] = torch.zeros(xshape, dtype=dtype, device=device)
        c["xpos"] = torch.arange(cfg.encoder_seq, dtype=torch.int32,
                                 device=device)
    return c


def effective_cache_len(cfg: ModelConfig, context_len: int) -> int:
    """Physical ring length: bounded by the sliding window."""
    if cfg.sliding_window is not None:
        return min(context_len, cfg.sliding_window)
    return context_len


def init_cache(cfg: ModelConfig, batch: int, context_len: int,
               dtype: Optional[torch.dtype] = None, *,
               device="cuda") -> Cache:
    """Full-model ring cache, one entry per layer: a ring for each ATTN
    layer (with the encoder's zero K/V on a cross-attention model, as the
    reference's ``layer_cache(cross=True)``), the zero recurrent state of
    each REC/SSD layer (``conv`` in ``dtype``, ``h`` / ``ssm`` in
    float32)."""
    dtype = dtype or cfg.torch_dtype
    clen = effective_cache_len(cfg, context_len)
    out: Cache = []
    for kind in cfg.layer_kinds:
        if kind == ATTN:
            out.append(attn_cache(cfg, batch, clen, dtype, device,
                                  cross=cfg.cross_attention))
        else:
            layer: Dict[str, Any] = slot_state_cache(kind, cfg, batch, dtype,
                                                     device=device)
            layer["idx"] = 0
            out.append(layer)
    return out


def reset_ring(cache: Cache) -> None:
    """Empty a ring cache in place, as ``init_cache`` made it: K/V and the
    encoder's ``xk`` / ``xv`` zero (a later prefill without frames then
    leaves them so, as on a fresh ring), every slot -1, REC/SSD state
    zero, every ``idx`` 0; the constant ``xpos`` stays."""
    for layer in cache:
        for name, t in layer.items():
            if name == "idx":
                layer[name] = 0
            elif name == "slot_pos":
                t.fill_(-1)
            elif name != "xpos":
                t.zero_()


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
    """None if the paged runtime can serve the config.

    ATTN layers page their K/V through the shared block pool; REC and SSD
    layers carry per-slot state rows beside it (``slot_state_spec``), so
    hybrid and attention-free stacks are servable.  Only encoder /
    cross-attention models stay out, as in the reference."""
    if cfg.cross_attention or cfg.encoder_layers:
        return "paged serving does not support encoder/cross-attention models"
    return None


def slot_state_spec(kind: str, cfg: ModelConfig,
                    dtype: Optional[torch.dtype] = None
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """Per-slot state tensors of ONE layer of ``kind``: name -> (per-slot
    shape, dtype).  ATTN layers return {} (their state is paged K/V)."""
    dtype = dtype or cfg.torch_dtype
    Di, W = cfg.d_inner, cfg.ssm_conv_width
    if kind == REC:
        return {"conv": ((W - 1, Di), dtype), "h": ((Di,), torch.float32)}
    if kind == SSD:
        return {"conv": ((W - 1, Di), dtype),
                "ssm": ((cfg.ssm_num_heads, cfg.ssm_head_dim,
                         cfg.ssm_state_dim), torch.float32)}
    return {}


def slot_state_cache(kind: str, cfg: ModelConfig, rows: int,
                     dtype: Optional[torch.dtype] = None, *,
                     device="cuda") -> Dict[str, torch.Tensor]:
    """One REC/SSD layer's slot-state tensors: {name: (rows, ...)}."""
    return {k: torch.zeros((rows,) + shp, dtype=dt, device=device)
            for k, (shp, dt) in slot_state_spec(kind, cfg, dtype).items()}


def state_bytes_per_slot(cfg: ModelConfig,
                         dtype: Optional[torch.dtype] = None) -> int:
    """Bytes of dense recurrent state ONE slot pins across the whole stack
    (the REC/SSD analogue of the per-slot paged-KV working set)."""
    total = 0
    for kind in cfg.layer_kinds:
        for shp, dt in slot_state_spec(kind, cfg, dtype).values():
            n = 1
            for d in shp:
                n *= d
            total += n * torch.empty((), dtype=dt).element_size()
    return total


def gather_slot_state(state: Dict[str, torch.Tensor], rows: torch.Tensor,
                      positions: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One layer's slot-state rows in dispatch-row order.

    ``rows``: (B,) int32 state row of each dispatch row (the garbage row
    for padding and stalled rows); ``positions``: (B, T) the rows'
    positions.  A row whose first position is 0 starts a fresh prompt on a
    recycled slot and reads ZERO state instead of the previous tenant's,
    so admission needs no reset.  Device ops only (no host read): the
    captured dispatches run it."""
    fresh = positions[:, 0] == 0
    out = {}
    for name, t in state.items():
        s = t.index_select(0, rows.long())
        m = fresh.reshape((-1,) + (1,) * (s.dim() - 1))
        out[name] = torch.where(m, torch.zeros_like(s), s)
    return out


def scatter_slot_state(state: Dict[str, torch.Tensor],
                       new: Dict[str, torch.Tensor],
                       rows: torch.Tensor) -> None:
    """Write updated per-row state back to its slot rows, in place (the
    inverse of ``gather_slot_state``).  Duplicate garbage-row writes land
    in any order; the garbage row is never read as real state."""
    for name, t in state.items():
        t.index_copy_(0, rows.long(), new[name].to(t.dtype))


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     dtype: Optional[torch.dtype] = None, *,
                     num_slots: Optional[int] = None,
                     device="cuda") -> Cache:
    """Full-model paged cache, one entry per layer: a block pool for each
    ATTN layer, ``(num_slots + 1, ...)`` slot-state rows (the last row is
    the garbage row) for each REC/SSD layer."""
    reason = paging_unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(reason)
    dtype = dtype or cfg.torch_dtype
    if has_slot_state(cfg) and num_slots is None:
        raise ValueError(
            "config has REC/SSD layers: init_paged_cache needs num_slots "
            "to size the per-slot state rows (+1 garbage row)")
    return [paged_attn_cache(cfg, num_blocks, block_size, dtype, device)
            if kind == ATTN else
            slot_state_cache(kind, cfg, num_slots + 1, dtype, device=device)
            for kind in cfg.layer_kinds]
