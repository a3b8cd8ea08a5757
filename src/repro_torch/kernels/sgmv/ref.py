"""Plain PyTorch version of SGMV (the CUDA kernel's oracle).

y[i] = scaling * (x[i] @ A[idx[i]]) @ B[idx[i]], with xa kept in float32
and the result cast to x's dtype; rows whose ``idx`` lies outside [0, N)
are exact zeros (the reference computes them as adapter 0 and zeroes the
delta, ``repro/kernels/sgmv/ops.py``).

x: (R, D); a: (N, D, r); b: (N, r, O); idx: (R,) int.  Returns (R, O).
"""
from __future__ import annotations

import torch


def sgmv_ref(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             idx: torch.Tensor, *, scaling: float = 1.0) -> torch.Tensor:
    N = a.shape[0]
    valid = (idx >= 0) & (idx < N)
    safe = torch.where(valid, idx, torch.zeros_like(idx)).long()
    ag = a[safe].float()                                 # (R, D, r)
    bg = b[safe].float()                                 # (R, r, O)
    xa = torch.einsum("rd,rdk->rk", x.float(), ag)
    y = (scaling * torch.einsum("rk,rko->ro", xa, bg)).to(x.dtype)
    return torch.where(valid[:, None], y, torch.zeros((), dtype=y.dtype,
                                                      device=y.device))
