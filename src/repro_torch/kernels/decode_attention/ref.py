"""Plain PyTorch version of single-token GQA decode attention over a ring
KV cache (port of ``repro/kernels/decode_attention/ref.py``).

One query token per row attends to a cache whose slots carry absolute
positions (``slot_pos``; -1 = empty).  A slot is valid when
``0 <= slot_pos <= pos`` (and ``slot_pos > pos - window`` with a window).
Invalid slots get probability exactly 0, as in the kernel; with no valid
slot a row yields zeros (the reference would average every slot; the
engine always has the row's own token, written before it attends).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch

from repro_torch.kernels.paged_attention.ref import masked_attention


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         slot_pos: torch.Tensor,
                         pos: Union[int, torch.Tensor], *,
                         window: Optional[int] = None,
                         return_lse: bool = False):
    """q: (B, H, hd); k, v: (B, S, K, hd); slot_pos: (S,) int; pos: a
    scalar.  Returns (B, H, hd) in q's dtype, computed in float32; with
    ``return_lse`` also the log of the sum of exp scores over the valid
    slots, (B, H) float32 (-inf with none)."""
    B, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) / math.sqrt(hd)
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        ok = ok & (slot_pos > pos - window)
    o = masked_attention(s, ok, v.float().permute(0, 2, 1, 3))
    out = o.reshape(B, H, hd).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(ok, s, torch.full_like(s, -math.inf)).logsumexp(-1)
    return out, lse.reshape(B, H)
