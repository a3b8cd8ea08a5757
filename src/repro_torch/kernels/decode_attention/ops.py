"""Ring-cache decode attention wrapper.

``decode_gqa`` launches the CUDA kernel (``csrc/decode_attn.cu``) for CUDA
tensors, and takes the plain version (``ref.decode_attention_ref``) only
for CPU tensors.  In bfloat16 it is one launch: a cluster of CTAs per
(row, kv head, group of at most 8 query heads) walks the ring's
partitions through a pipelined shared-memory ring fed by TMA, testing
each slot against ``slot_pos``, and merges its CTAs' partial softmax in
shared memory (``csrc/ring_decode_step.cuh``; the library picks the
cluster size and the partition, ``ring_decode_plan``).  float32 keeps
the split-KV kernels: one CTA per (row, kv head, partition of
``PARTITION`` slots) staging K/V with ``cp.async``, then a merge kernel.

The kernel reads the engine's (B, S, K, hd) cache in place; the
reference's wrapper copies it to (B, K, S, hd) on every step.  ``pos`` is
a Python int (the engine's decode loop holds it on the host) or a 0-d
int32 tensor on the card; neither is read back to the host.

A kv head with more than 8 query heads (up to ``MAX_GROUP``) is served
by groups of 8 heads, each group in CTAs of its own.

``decode_gqa.launches`` counts calls that launched the kernel; ``work``
gives the FLOPs and bytes its bound counts.  On meta tensors (the dry
run) the wrapper returns an output of the kernel's shape and computes
nothing.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

PARTITION = 64           # float32: slots per split-KV partition (max 128)
HEAD_DIMS = (32, 64, 128, 192, 256)
MAX_GROUP = 16           # query heads per kv head


def decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               slot_pos: torch.Tensor, pos: Union[int, torch.Tensor], *,
               window: Optional[int] = None, return_lse: bool = False):
    """q: (B, H, hd); k, v: (B, S, K, hd) (engine cache layout); slot_pos:
    (S,) int32; pos: the current absolute decode position.  Returns
    (B, H, hd); with ``return_lse`` also each row's and head's log of the
    sum of exp scores over its valid slots, (B, H) float32 (-inf with
    none), written by the bf16 kernel's merge (float32: from the
    partitions' (max, sum)): what a merge across devices that split the
    slots needs (``models/layers.py::_merge_partials``)."""
    B, H, hd = q.shape
    Bk, S, K, hd_k = k.shape
    pos_t = pos if isinstance(pos, torch.Tensor) else None
    if (v.shape != k.shape or Bk != B or hd_k != hd or H % K
            or slot_pos.shape != (S,)
            or (pos_t is not None and pos_t.dim() != 0)
            or (window is not None and window < 1)):
        raise ValueError(f"ring decode shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(k.shape)}, slot_pos "
                         f"{tuple(slot_pos.shape)}, pos {pos!r}, window "
                         f"{window}")
    extra = () if pos_t is None else (pos_t,)
    kind = cuda_lib.device_kind(q, k, v, slot_pos, *extra)
    if kind == "cpu":
        return decode_attention_ref(q, k, v, slot_pos, pos, window=window,
                                    return_lse=return_lse)
    if kind == "meta":
        out = cuda_lib.meta_call(
            "decode_attention", work(q, k, v, slot_pos, pos, window=window),
            torch.empty_like(q))
        return (out, q.new_empty((B, H), dtype=torch.float32)) \
            if return_lse else out
    cuda_lib.refuse_autograd("ring decode", q, k, v)
    code = cuda_lib.dtype_code(q, k, v)
    cuda_lib.require_int32(slot_pos, *extra)
    cuda_lib.require_contiguous(q=q, k=k, v=v, slot_pos=slot_pos)
    cuda_lib.require_aligned(q=q, k=k, v=v)
    G = H // K
    if hd not in HEAD_DIMS or G > MAX_GROUP:
        raise ValueError(f"ring decode kernel supports head_dim {HEAD_DIMS} "
                         f"and <= {MAX_GROUP} query heads per kv head, got "
                         f"hd={hd}, G={G}")
    out = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = m = l = lse = None
    if q.dtype == torch.bfloat16:
        if return_lse:
            lse = torch.empty((B, H), **f32)
    else:
        NP = -(-S // PARTITION)
        acc = torch.empty((B, K, G, NP, hd), **f32)
        m = torch.empty((B, K, G, NP), **f32)
        l = torch.empty((B, K, G, NP), **f32)
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    cuda_lib.check(cuda_lib.library().ring_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(),
        ptr(pos_t), ptr(acc), ptr(m), ptr(l), out.data_ptr(), ptr(lse),
        0 if pos_t is not None else int(pos), B, K, G, S, hd, PARTITION,
        window if window is not None else 0, code,
        cuda_lib.stream_of(q)), "ring_decode")
    decode_gqa.launches += 1
    if not return_lse:
        return out
    if lse is None:              # float32: from the partitions' (m, l)
        lse = torch.logsumexp(m + torch.log(l), -1).reshape(B, H)
    return out, lse


decode_gqa.launches = 0


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         slot_pos: torch.Tensor, pos: Union[int, torch.Tensor], *,
         window: Optional[int] = None) -> cuda_lib.Work:
    """Bytes: q and the output, K and V of each valid slot once, slot_pos;
    operations: 4 hd per valid slot and query head.  A slot is valid when
    its position is in [0, pos] (and inside the window).  On the meta
    device the slots' positions are unknown: a full ring, every slot
    valid (bounded by ``pos + 1`` when pos is an int, and the window)."""
    B, H, hd = q.shape
    S, K = k.shape[1], k.shape[2]
    if slot_pos.device.type == "meta" or (
            isinstance(pos, torch.Tensor) and pos.device.type == "meta"):
        valid = S if isinstance(pos, torch.Tensor) else min(S, int(pos) + 1)
        if window is not None:
            valid = min(valid, window)
    else:
        p = int(pos)
        ok = (slot_pos >= 0) & (slot_pos <= p)
        if window is not None:
            ok = ok & (slot_pos > p - window)
        valid = int(ok.sum())
    es = q.element_size()
    return cuda_lib.Work(flops=4 * hd * H * B * valid,
                         bytes=es * (2 * B * valid * K * hd + 2 * B * H * hd)
                         + 4 * S, dtype=q.dtype)
