"""Plain PyTorch version of paged single-token GQA decode attention.

Gather semantics spelled out: clip the block table onto the garbage block,
materialise every row's logical K/V view, and mask by absolute position.
Logical key index ``t`` of a row at position ``pos`` is valid when
``t <= pos``, its table entry is allocated (``!= -1``) and, with a window,
``t > pos - window``.  Masked keys get probability exactly 0 (as in the
reference's fused walk, ``repro/kernels/paged_attention/ops.py``), so a row
with no valid key — an inactive slot — yields zeros, not a mean over the
garbage block.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def masked_attention(s: torch.Tensor, ok: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """softmax over the valid keys of ``s`` (..., S) applied to v (..., S,
    hd), with invalid keys at probability exactly 0 and an empty row at 0.
    Float32 throughout."""
    m = torch.where(ok, s, torch.full_like(s, -1e30)).amax(dim=-1,
                                                           keepdim=True)
    p = torch.where(ok, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    return (p @ v) / torch.clamp(l, min=1e-30)


def paged_attention_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        block_tbl: torch.Tensor, pos: torch.Tensor, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, hd); kp, vp: (K, NB, bs, hd); block_tbl: (B, MB) int;
    pos: (B,) int.  Returns (B, H, hd) in q's dtype."""
    B, H, hd = q.shape
    K, _, bs, _ = kp.shape
    G = H // K
    MB = block_tbl.shape[1]
    phys = block_tbl.clamp(min=0).long()                 # -1 -> garbage
    # (K, B, MB, bs, hd) -> (B, K, MB*bs, hd) logical view
    k = kp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, MB * bs, hd)
    v = vp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, MB * bs, hd)
    kpos = torch.arange(MB * bs, device=q.device)
    ok = (kpos[None] <= pos[:, None]) & (block_tbl[:, kpos // bs] >= 0)
    if window is not None:
        ok = ok & (kpos[None] > pos[:, None] - window)
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, k.float()) / math.sqrt(hd)
    o = masked_attention(s, ok[:, None, None, :], v.float())
    return o.reshape(B, H, hd).to(q.dtype)
