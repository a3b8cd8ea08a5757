"""Dense flash attention wrapper (the ring-cache engine's prefill).

``flash_mha`` launches the CUDA kernel (``csrc/flash_attn.cu``: one CTA
per (batch row, kv head, tile of 64 or 128 query-head rows, by the rule
of ``csrc/prefill_tile.cuh::wg::tile_rows`` in bf16, 64 in float32), a
walk over the keys bounded by causality and the window) for CUDA tensors,
and takes the plain version (``ref.flash_ref``) only for CPU tensors.

Unlike the reference's wrapper, which pads T to whole blocks and
transposes to (B, H, T, hd), the kernel reads the model's layout in place
and masks the ragged edge by length, causal or not (the reference leaves
padded keys unmasked when ``causal=False``).  ``prefix_len`` is the
reference model's prefix-LM rule (``_scores_mask(kind="prefix")``, the VLM
image prefix): keys at positions below it are visible to every query.
``q_offset`` puts the queries at positions ``q_offset + i`` (a chunk of a
longer prefill's queries, as a sharded ring prefill splits them), the keys
staying at ``j``.

``flash_mha.launches`` counts calls that launched the kernel; ``work``
gives the FLOPs and bytes its bound counts.  On meta tensors (the dry
run) the wrapper returns an output of the kernel's shape and computes
nothing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.flash_attention.ref import flash_ref

HEAD_DIMS = (32, 64, 128, 192, 256)


def flash_mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              prefix_len: int = 0, q_offset: int = 0) -> torch.Tensor:
    """q: (B, Tq, H, hd); k, v: (B, Tk, K, hd), H % K == 0.  Query i and
    key j sit at positions ``q_offset`` + i and j; with ``causal`` query i
    sees keys j <= ``q_offset`` + i and j < ``prefix_len``, so it needs
    ``q_offset`` + Tq <= Tk.  Returns (B, Tq, H, hd)."""
    B, Tq, H, hd = q.shape
    Bk, Tk, K, hd_k = k.shape
    if (v.shape != k.shape or Bk != B or hd_k != hd or H % K or Tk < 1
            or (window is not None and window < 1) or prefix_len < 0
            or q_offset < 0 or (causal and q_offset + Tq > Tk)):
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, window "
                         f"{window}, prefix_len {prefix_len}, q_offset "
                         f"{q_offset}")
    kind = cuda_lib.device_kind(q, k, v)
    if kind == "cpu":
        return flash_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         prefix_len=prefix_len,
                         q_offset=q_offset).transpose(1, 2)
    if kind == "meta":
        return cuda_lib.meta_call(
            "flash_attention", work(q, k, v, causal=causal, window=window,
                                    prefix_len=prefix_len,
                                    q_offset=q_offset),
            torch.empty_like(q))
    cuda_lib.refuse_autograd("flash attention", q, k, v)
    code = cuda_lib.dtype_code(q, k, v)
    cuda_lib.require_contiguous(q=q, k=k, v=v)
    cuda_lib.require_aligned(q=q, k=k, v=v)
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention kernel supports head_dim "
                         f"{HEAD_DIMS}, got {hd}")
    out = torch.empty_like(q)
    if B * Tq == 0:
        return out
    cuda_lib.check(cuda_lib.library().flash_attn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Tq, Tk,
        K, H // K, hd, int(causal), window if window is not None else 0,
        prefix_len, q_offset, code, cuda_lib.stream_of(q)), "flash_attn")
    flash_mha.launches += 1
    return out


flash_mha.launches = 0


def visible_pairs(Tq: int, Tk: int, *, causal: bool = True,
                  window: Optional[int] = None, prefix_len: int = 0,
                  q_offset: int = 0) -> int:
    """(query, key) pairs the kernel's mask leaves visible: query i, at
    position p = ``q_offset`` + i, sees key j < Tk where j <= p or
    j < ``prefix_len`` (every j without ``causal``), and j > p -
    ``window``."""
    i = q_offset + np.arange(Tq, dtype=np.int64)
    hi = np.full(Tq, Tk, np.int64) if not causal else \
        np.minimum(np.maximum(prefix_len, i + 1), Tk)
    lo = np.zeros(Tq, np.int64) if window is None else \
        np.maximum(i - window + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, window: Optional[int] = None,
         prefix_len: int = 0, q_offset: int = 0) -> cuda_lib.Work:
    """Bytes: q and the output once, K and V once per row; operations: a
    QK^T and a PV product (2 hd each) per visible pair and query head."""
    B, Tq, H, hd = q.shape
    Tk, K = k.shape[1], k.shape[2]
    pairs = visible_pairs(Tq, Tk, causal=causal, window=window,
                          prefix_len=prefix_len, q_offset=q_offset)
    es = q.element_size()
    return cuda_lib.Work(flops=4 * hd * H * B * pairs,
                         bytes=es * (2 * B * Tq * H * hd + 2 * B * Tk * K * hd),
                         dtype=q.dtype)
