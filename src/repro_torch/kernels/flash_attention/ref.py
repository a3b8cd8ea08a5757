"""Plain PyTorch version of dense GQA attention with causal and
sliding-window masks (port of ``repro/kernels/flash_attention/ref.py``).

Query ``i`` sits at position ``q_offset + i`` and key ``j`` at ``j`` (a
chunk of a longer sequence's queries over its keys).  A key is kept when
``j <= q`` or ``j < prefix_len`` for the query's position ``q`` (causal;
the reference model's prefix-LM mask, ``_scores_mask(kind="prefix")``)
and ``j > q - window`` (with a window).  Masked
keys get probability exactly 0, as in the kernel; a query that keeps no
key yields zeros (the reference's softmax over -1e30 would average every
key there; no caller has such a row).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.paged_attention.ref import masked_attention


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              prefix_len: int = 0, q_offset: int = 0) -> torch.Tensor:
    """q: (B, H, Tq, hd); k, v: (B, K, Tk, hd).  Returns (B, H, Tq, hd) in
    q's dtype, computed in float32."""
    B, H, Tq, hd = q.shape
    K, Tk = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, Tq, hd).float()
    s = torch.einsum("bkgqh,bksh->bkgqs", qg, k.float()) / math.sqrt(hd)
    qp = q_offset + torch.arange(Tq, device=q.device)[:, None]
    kp = torch.arange(Tk, device=q.device)[None, :]
    ok = torch.ones((Tq, Tk), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & ((kp <= qp) | (kp < prefix_len))
    if window is not None:
        ok = ok & (kp > qp - window)
    o = masked_attention(s, ok, v.float()[:, :, None])
    return o.reshape(B, H, Tq, hd).to(q.dtype)
