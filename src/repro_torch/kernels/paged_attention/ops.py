"""Paged decode attention wrapper.

``paged_decode_gqa`` launches the CUDA kernel (``csrc/paged_attn.cu``)
for CUDA tensors, and takes the plain version (``ref.paged_attention_ref``)
only for CPU tensors.  In bfloat16 it is one launch: a cluster of CTAs
per (row, kv head) with all of its query heads (up to ``MAX_GROUP``, the
rows of one tensor-core tile) splits the row's live range on the device,
resolves the block table a stage at a time and copies the stage's blocks
with TMA (token by token with ``cp.async`` where a block size leaves
pieces of a stage that are not a multiple of 8 tokens), and merges its
CTAs' partial softmax in shared memory, on the step ring decode runs too
(``csrc/ring_decode_step.cuh``; the library picks the cluster size and the
stage, ``paged_decode_plan``).  float32 keeps the split-KV kernels: one
CTA per (row, kv head, group of 8 query heads, partition of ``PARTITION``
tokens) staging K/V with ``cp.async``, then a merge kernel.

``paged_decode_gqa.launches`` counts calls that launched the kernel;
``work`` gives the FLOPs and bytes its bound counts.  On meta tensors the
wrapper returns an output of the kernel's shape and computes nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

PARTITION = 64           # float32: tokens per split-KV partition (max 128)
HEAD_DIMS = (32, 64, 128, 192, 256)
MAX_GROUP = 16           # query heads per kv head


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
    kind = cuda_lib.device_kind(q, kp, vp, block_tbl, pos)
    if kind == "cpu":
        return paged_attention_ref(q, kp, vp, block_tbl, pos, window=window)
    if kind == "meta":
        return cuda_lib.meta_call(
            "paged_attention", work(q, kp, vp, block_tbl, pos, window=window),
            torch.empty_like(q))
    cuda_lib.refuse_autograd("paged decode", q, kp, vp)
    code = cuda_lib.dtype_code(q, kp, vp)
    cuda_lib.require_int32(block_tbl, pos)
    cuda_lib.require_contiguous(q=q, kp=kp, vp=vp, block_tbl=block_tbl,
                                pos=pos)
    cuda_lib.require_aligned(q=q, kp=kp, vp=vp)
    G = H // K
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"paged decode kernel supports head_dim "
                         f"{HEAD_DIMS} and <= {MAX_GROUP} query heads per "
                         f"kv head, got hd={hd}, G={G}")
    out = torch.empty_like(q)
    scratch = [None] * 3          # bf16: none (one launch)
    if q.dtype != torch.bfloat16:
        S = -(-(MB * bs) // PARTITION)
        f32 = dict(dtype=torch.float32, device=q.device)
        scratch = [torch.empty(shape, **f32) for shape in
                   ((B, K, G, S, hd), (B, K, G, S), (B, K, G, S))]
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    cuda_lib.check(cuda_lib.library().paged_decode(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), block_tbl.data_ptr(),
        pos.data_ptr(), *map(ptr, scratch), out.data_ptr(), B, K, G, NB, bs, MB, hd,
        PARTITION, window if window is not None else 0, code,
        cuda_lib.stream_of(q)), "paged_decode")
    paged_decode_gqa.launches += 1
    return out


paged_decode_gqa.launches = 0


def work(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
         block_tbl: torch.Tensor, pos: torch.Tensor, *,
         window: Optional[int] = None) -> cuda_lib.Work:
    """Bytes: q and the output, K and V of each live key once, the table
    and positions; operations: 4 hd per live key and query head.  A key at
    position t of row b is live when t <= pos[b], its block is allocated
    and t is inside the window.  On the meta device (contents unknown)
    every row is taken to fill its whole table."""
    B, H, hd = q.shape
    K, _, bs, _ = kp.shape
    MB = block_tbl.shape[1]
    if block_tbl.device.type == "meta" or pos.device.type == "meta":
        live = B * (MB * bs if window is None else min(MB * bs, window))
    else:
        t = torch.arange(MB * bs, device=pos.device)
        ok = (t[None] <= pos[:, None]) & (block_tbl[:, t // bs] >= 0)
        if window is not None:
            ok = ok & (t[None] > pos[:, None] - window)
        live = int(ok.sum())
    es = q.element_size()
    return cuda_lib.Work(flops=4 * hd * H * live,
                         bytes=es * (2 * live * K * hd + 2 * B * H * hd)
                         + 4 * (B * MB + B), dtype=q.dtype)
