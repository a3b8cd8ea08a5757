"""Chunked paged prefill attention wrapper.

``paged_prefill_gqa`` launches the CUDA kernel (``csrc/paged_prefill.cu``:
one CTA per (row, kv head, tile of 64 query-head rows), in-kernel
block-table walk bounded by the tile's last query and the window) for CUDA tensors, and takes the
plain version (``ref.paged_prefill_ref``) only for CPU tensors.  Like the
Pallas kernel, the CUDA kernel takes each row's chunk start (B,); the
wrapper derives it from ``q_pos[:, 0]`` and hands the kernel ``q_pos`` as
well, which asserts on the device that the positions are that contiguous
run (no host synchronisation).

``paged_prefill_gqa.launches`` counts calls that launched the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref

HEAD_DIMS = (32, 64, 128)


def paged_prefill_gqa(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      block_tbl: torch.Tensor, q_pos: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """q: (B, C, H, hd); kp, vp: (K, NB, bs, hd) pools already holding the
    chunk's K/V; block_tbl: (B, MB) int32; q_pos: (B, C) int32 contiguous
    ascending absolute positions.  Returns (B, C, H, hd)."""
    B, C, H, hd = q.shape
    K, NB, bs, hd_p = kp.shape
    MB = block_tbl.shape[1]
    if (vp.shape != kp.shape or hd_p != hd or H % K
            or block_tbl.shape[0] != B or q_pos.shape != (B, C)):
        raise ValueError(f"paged prefill shapes: q {tuple(q.shape)}, pools "
                         f"{tuple(kp.shape)}, table {tuple(block_tbl.shape)},"
                         f" q_pos {tuple(q_pos.shape)}")
    if not cuda_lib.on_cuda(q, kp, vp, block_tbl, q_pos):
        return paged_prefill_ref(q, kp, vp, block_tbl, q_pos, window=window)
    code = cuda_lib.dtype_code(q, kp, vp)
    cuda_lib.require_int32(block_tbl, q_pos)
    cuda_lib.require_contiguous(q=q, kp=kp, vp=vp, block_tbl=block_tbl,
                                q_pos=q_pos)
    G = H // K
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged prefill kernel supports head_dim "
                         f"{HEAD_DIMS}, got {hd}")
    start = q_pos[:, 0].contiguous()
    out = torch.empty_like(q)
    cuda_lib.check(cuda_lib.library().paged_prefill(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), block_tbl.data_ptr(),
        start.data_ptr(), q_pos.data_ptr(), out.data_ptr(), B, C, K, G, NB,
        bs, MB, hd, window if window is not None else 0,
        code, cuda_lib.stream_of(q)), "paged_prefill")
    paged_prefill_gqa.launches += 1
    return out


paged_prefill_gqa.launches = 0
