"""Core layers for the serving main path (port of the main-path subset of
``repro/models/layers.py``): dense + multi-LoRA delta, RMSNorm, RoPE,
SwiGLU, and the two paged branches of attention.

Parameters are plain dicts of tensors in the reference's layout
(``x @ W`` with W of shape (d_in, d_out)), so weights carry over from the
JAX package unchanged.  LoRA is unmerged: the backbone product and the
per-row adapter delta (SGMV) are computed separately and summed — the
paper's backbone-sharing requirement.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention.ops import paged_decode_gqa
from repro_torch.kernels.paged_prefill.ops import paged_prefill_gqa
from repro_torch.kernels.sgmv.ops import sgmv_tokens
from repro_torch.models.config import SWIGLU, ModelConfig

Params = Dict[str, Any]


# ------------------------------------------------------------------- dense/LoRA
def lora_delta(x: torch.Tensor, lora: Params, adapter_idx: torch.Tensor, *,
               scaling: float = 1.0) -> torch.Tensor:
    """Per-row multi-LoRA delta  scaling * (x @ A[idx]) @ B[idx].

    x: (B, T, D); adapter_idx: (B,) or per token (B * T,) int32; lora
    holds stacked banks
    {"a": (N, D, r), "b": (N, r, O)}.  Every LoRA site of both serving
    dispatches goes through SGMV here.  Rows whose id falls outside the
    bank get a zero delta."""
    return sgmv_tokens(x, lora["a"], lora["b"], adapter_idx, scaling=scaling)


def dense(x: torch.Tensor, p: Params, lora: Optional[Params] = None, *,
          scaling: float = 1.0,
          adapter_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W (+ b) (+ per-row multi-LoRA delta, cast to y's dtype)."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    if lora is not None:
        if adapter_idx is None:
            raise ValueError("a LoRA bank needs per-row adapter_idx")
        y = y + lora_delta(x, lora, adapter_idx,
                           scaling=scaling).to(y.dtype)
    return y


# ----------------------------------------------------------------------- norms
def apply_norm(x: torch.Tensor, p: Params, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, computed in float32 and cast back to x's dtype."""
    if kind != "rmsnorm":
        raise ValueError(f"norm {kind!r} is not ported yet")
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ------------------------------------------------------------------------ RoPE
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T).  Computed in float32, cast once
    to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (B, T, half)
    cos = torch.cos(ang)[..., None, :]                      # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- attention
def _write_decode_kv(pool: torch.Tensor, new: torch.Tensor,
                     block_tbl: torch.Tensor, pos: torch.Tensor) -> None:
    """Write one token per row at block_tbl[b, pos // bs], offset pos % bs,
    in place.  A -1 entry (inactive/stalled row) and a block index past the
    table's width both land in the garbage block 0 — the reference gets the
    latter from ``take_along_axis``'s out-of-range fill (INT32_MIN, then
    ``max(., 0)``), which the runtime relies on for stalled slots."""
    bs = pool.shape[2]
    MB = block_tbl.shape[1]
    j = torch.div(pos, bs, rounding_mode="floor").long()
    inside = j < MB
    blk = torch.gather(block_tbl, 1, j.clamp(max=MB - 1)[:, None])[:, 0]
    blk = torch.where(inside, blk, torch.full_like(blk, -1)).clamp(min=0)
    off = torch.remainder(pos, bs).long()
    pool[:, blk.long(), off] = new.to(pool.dtype).transpose(0, 1)


def apply_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                    positions: torch.Tensor, cache: Dict[str, torch.Tensor],
                    block_tbl: torch.Tensor,
                    adapter_idx: Optional[torch.Tensor] = None,
                    chunk_ids: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """GQA attention over the paged block pools (serving).

    x: (B, T, D); positions: (B, T) absolute positions; cache: one layer's
    {"kp","vp"}: (K, NB, bs, hd) pools, updated IN PLACE; block_tbl:
    (B, MB) int32 logical -> physical block map (-1 = unallocated).

    T > 1 is chunked paged prefill: the chunk's K/V go straight into whole
    pool blocks (``chunk_ids`` (B, T//bs) physical ids; garbage-block
    entries are skipped writes), then the chunk's queries attend over the
    row's entire paged history through the table.  T == 1 is decode: each
    row writes its token at block_tbl[b, pos//bs] offset pos%bs, then
    attends over its own blocks.  Returns the (B, T, D) mixer output."""
    B, T, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    lora = p.get("lora", {})
    s = cfg.lora.scaling if cfg.lora else 1.0

    q = dense(x, p["wq"], lora.get("q"), scaling=s, adapter_idx=adapter_idx)
    k = dense(x, p["wk"], lora.get("k"), scaling=s, adapter_idx=adapter_idx)
    v = dense(x, p["wv"], lora.get("v"), scaling=s, adapter_idx=adapter_idx)
    q = rope(q.reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, T, K, hd), positions, cfg.rope_theta)
    v = v.reshape(B, T, K, hd)
    kp, vp = cache["kp"], cache["vp"]
    bs = kp.shape[2]

    if T > 1:
        if chunk_ids is None or T % bs:
            raise ValueError("paged prefill needs chunk_ids and a chunk of "
                             "whole blocks")
        nb_c = T // bs
        # (B, T, K, hd) -> (K, B, nb_c, bs, hd); several rows may target the
        # garbage block at once, which is never read
        ids = chunk_ids.long()
        kp[:, ids] = k.reshape(B, nb_c, bs, K, hd).permute(
            3, 0, 1, 2, 4).to(kp.dtype)
        vp[:, ids] = v.reshape(B, nb_c, bs, K, hd).permute(
            3, 0, 1, 2, 4).to(vp.dtype)
        out = paged_prefill_gqa(q, kp, vp, block_tbl, positions,
                                window=window)
    else:
        pos = positions[:, -1]
        _write_decode_kv(kp, k[:, 0], block_tbl, pos)
        _write_decode_kv(vp, v[:, 0], block_tbl, pos)
        out = paged_decode_gqa(q[:, 0], kp, vp, block_tbl, pos,
                               window=window)
    return dense(out.reshape(B, T, H * hd), p["wo"], lora.get("o"),
                 scaling=s, adapter_idx=adapter_idx)


# ------------------------------------------------------------------------ MLPs
def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ Wg) * (x @ Wi)) @ Wo."""
    if cfg.mlp_for != SWIGLU:
        raise ValueError(f"mlp {cfg.mlp_for!r} is not ported yet")
    h = F.silu(x @ p["wg"]["w"]) * (x @ p["wi"]["w"])
    return h @ p["wo"]["w"]
