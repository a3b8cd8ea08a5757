"""Plain PyTorch version of chunked paged prefill attention.

Write-before-attend: the chunk's K/V already sit in the pool blocks its
table row maps, so this is a pure gather — each row's logical K/V view
through the table, masked by absolute position.  Logical key index ==
absolute position, so one causal rule ``kpos <= qpos`` covers the paged
history (earlier chunks, prefix-shared blocks) and in-chunk causality;
-1 table entries clip onto the garbage block for the gather and are
masked; a window also masks ``kpos <= qpos - window``.  Masked keys get
probability exactly 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.paged_attention.ref import masked_attention


def paged_prefill_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      block_tbl: torch.Tensor, q_pos: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """q: (B, C, H, hd) chunk queries; kp, vp: (K, NB, bs, hd) pools
    (chunk K/V already written); block_tbl: (B, MB) int; q_pos: (B, C) int
    absolute query positions.  Returns (B, C, H, hd) in q's dtype."""
    B, C, H, hd = q.shape
    K, _, bs, _ = kp.shape
    G = H // K
    MB = block_tbl.shape[1]
    phys = block_tbl.clamp(min=0).long()
    k = kp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, MB * bs, hd)
    v = vp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, MB * bs, hd)
    kpos = torch.arange(MB * bs, device=q.device)
    qp = q_pos[:, :, None]                                   # (B, C, 1)
    ok = (kpos[None, None] <= qp) & \
        (block_tbl[:, kpos // bs] >= 0)[:, None, :]          # (B, C, S)
    if window is not None:
        ok = ok & (kpos[None, None] > qp - window)
    qg = q.reshape(B, C, K, G, hd).permute(0, 2, 3, 1, 4).float()
    s = torch.einsum("bkgch,bksh->bkgcs", qg, k.float()) / math.sqrt(hd)
    o = masked_attention(s, ok[:, None, None], v.float()[:, :, None])
    # (B, K, G, C, hd) -> (B, C, H, hd)
    return o.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)
