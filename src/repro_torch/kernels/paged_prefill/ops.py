"""Chunked paged prefill attention wrapper.

``paged_prefill_gqa`` launches the CUDA kernel (``csrc/paged_prefill.cu``:
one CTA per (row, kv head, tile of query-head rows, key partition),
in-kernel block-table walk bounded by the tile's last query and the
window) for CUDA tensors, and takes the plain version
(``ref.paged_prefill_ref``) only for CPU tensors.  In bf16 the library's
rule (``partitions``) may split each tile's key walk into parts whose rows
a second kernel merges by log-sum-exp; the wrapper allocates their
float32 scratch.  Like the Pallas kernel, the CUDA kernel takes each row's
chunk start (B,); the wrapper derives it from ``q_pos[:, 0]`` and hands
the kernel ``q_pos`` as well, which checks on the device that the
positions are that contiguous run (no host synchronisation; an assert in
float32, a trap in bf16).

``paged_prefill_gqa.launches`` counts calls that launched the kernel;
``work`` gives the FLOPs and bytes its bound counts.  On meta tensors the
wrapper returns an output of the kernel's shape and computes nothing.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref

HEAD_DIMS = (32, 64, 128, 192, 256)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def partitions(B: int, C: int, K: int, G: int, bs: int, MB: int, hd: int,
               window: Optional[int], device: torch.device) -> int:
    """Key partitions of the bf16 kernel's walk for this call on
    ``device``: the library's rule (``csrc/paged_prefill.cu::partitions``,
    the one the launcher's tile rule sits beside)."""
    S = cuda_lib.library().paged_prefill_partitions(
        B, C, K, G, bs, MB, hd, window or 0, _sms(device.index or 0))
    if S < 1:
        raise ValueError(f"paged prefill partitions: bad shape (B {B}, C "
                         f"{C}, K {K}, G {G}, bs {bs}, MB {MB}, hd {hd})")
    return S


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
    kind = cuda_lib.device_kind(q, kp, vp, block_tbl, q_pos)
    if kind == "cpu":
        return paged_prefill_ref(q, kp, vp, block_tbl, q_pos, window=window)
    if kind == "meta":
        return cuda_lib.meta_call(
            "paged_prefill", work(q, kp, vp, block_tbl, q_pos, window=window),
            torch.empty_like(q))
    cuda_lib.refuse_autograd("paged prefill", q, kp, vp)
    code = cuda_lib.dtype_code(q, kp, vp)
    cuda_lib.require_int32(block_tbl, q_pos)
    cuda_lib.require_contiguous(q=q, kp=kp, vp=vp, block_tbl=block_tbl,
                                q_pos=q_pos)
    cuda_lib.require_aligned(q=q, kp=kp, vp=vp)
    G = H // K
    if hd not in HEAD_DIMS:
        raise ValueError(f"paged prefill kernel supports head_dim "
                         f"{HEAD_DIMS}, got {hd}")
    start = q_pos[:, 0].contiguous()
    out = torch.empty_like(q)
    lib = cuda_lib.library()
    S, scratch = 1, [None, None, None]
    if q.dtype == torch.bfloat16:
        S = partitions(B, C, K, G, bs, MB, hd, window, q.device)
    if S > 1:
        scratch = [torch.empty((B * C * H, S, hd), dtype=torch.float32,
                               device=q.device),
                   torch.empty((B * C * H, S), dtype=torch.float32,
                               device=q.device),
                   torch.empty((B * C * H, S), dtype=torch.float32,
                               device=q.device)]
    cuda_lib.check(lib.paged_prefill(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), block_tbl.data_ptr(),
        start.data_ptr(), q_pos.data_ptr(), out.data_ptr(),
        *[t.data_ptr() if t is not None else None for t in scratch], B, C, K,
        G, NB, bs, MB, hd, window if window is not None else 0, S,
        code, cuda_lib.stream_of(q)), "paged_prefill")
    paged_prefill_gqa.launches += 1
    return out


paged_prefill_gqa.launches = 0


def work(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
         block_tbl: torch.Tensor, q_pos: torch.Tensor, *,
         window: Optional[int] = None) -> cuda_lib.Work:
    """Bytes: q and the output, K and V of each history key the chunk sees
    once, the table and positions; operations: 4 hd per visible (query,
    key) pair and query head.  On the meta device (contents unknown) every
    row's chunk is taken to end its whole, fully allocated table."""
    B, C, H, hd = q.shape
    K, _, bs, _ = kp.shape
    MB = block_tbl.shape[1]
    if block_tbl.device.type == "meta" or q_pos.device.type == "meta":
        tbl = torch.zeros((B, MB), dtype=torch.int32)
        start = torch.full((B,), MB * bs - C)
    else:
        tbl, start = block_tbl, q_pos[:, 0]
    qp = start[:, None] + torch.arange(C, device=start.device)[None]
    t = torch.arange(MB * bs, device=start.device)
    valid = tbl[:, t // bs] >= 0                               # (B, S)
    ok = (t[None, None] <= qp[:, :, None]) & valid[:, None]    # (B, C, S)
    seen = valid & (t[None] <= (start + C - 1)[:, None])
    if window is not None:
        ok = ok & (t[None, None] > qp[:, :, None] - window)
        seen = seen & (t[None] > (start - window)[:, None])
    es = q.element_size()
    return cuda_lib.Work(flops=4 * hd * H * int(ok.sum()),
                         bytes=es * (2 * int(seen.sum()) * K * hd
                                     + 2 * B * C * H * hd)
                         + 4 * (B * MB + B * C), dtype=q.dtype)
