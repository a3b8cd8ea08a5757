"""Paged decode attention wrapper.

``paged_decode_gqa`` launches the split-KV CUDA kernel
(``csrc/paged_attn.cu``: one CTA per (row, kv head, partition of
``PARTITION`` tokens) walking the block table in-kernel, then a merge
kernel) for CUDA tensors, and takes the plain version
(``ref.paged_attention_ref``) only for CPU tensors.

``paged_decode_gqa.launches`` counts calls that launched the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

PARTITION = 128          # tokens per split-KV partition (kernel max 128)
HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8            # query heads per kv head


def paged_decode_gqa(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                     block_tbl: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, hd); kp, vp: (K, NB, bs, hd) block pools; block_tbl:
    (B, MB) int32 (-1 = unallocated); pos: (B,) int32 per-row decode
    positions.  Returns (B, H, hd)."""
    B, H, hd = q.shape
    K, NB, bs, hd_p = kp.shape
    MB = block_tbl.shape[1]
    if (vp.shape != kp.shape or hd_p != hd or H % K
            or block_tbl.shape[0] != B or pos.shape != (B,)):
        raise ValueError(f"paged decode shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(kp.shape)}, table {tuple(block_tbl.shape)},"
                         f" pos {tuple(pos.shape)}")
    if not cuda_lib.on_cuda(q, kp, vp, block_tbl, pos):
        return paged_attention_ref(q, kp, vp, block_tbl, pos, window=window)
    code = cuda_lib.dtype_code(q, kp, vp)
    cuda_lib.require_int32(block_tbl, pos)
    cuda_lib.require_contiguous(q=q, kp=kp, vp=vp, block_tbl=block_tbl,
                                pos=pos)
    G = H // K
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"paged decode kernel supports head_dim "
                         f"{HEAD_DIMS} and <= {MAX_GROUP} query heads per "
                         f"kv head, got hd={hd}, G={G}")
    S = -(-(MB * bs) // PARTITION)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, K, G, S, hd), **f32)
    m = torch.empty((B, K, G, S), **f32)
    l = torch.empty((B, K, G, S), **f32)
    out = torch.empty_like(q)
    cuda_lib.check(cuda_lib.library().paged_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), block_tbl.data_ptr(),
        pos.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
        out.data_ptr(), B, K, G, NB, bs, MB, hd, PARTITION,
        window if window is not None else 0, code, cuda_lib.stream_of(q)),
        "paged_decode")
    paged_decode_gqa.launches += 1
    return out


paged_decode_gqa.launches = 0
