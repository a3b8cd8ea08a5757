"""SGMV wrappers: per-row multi-LoRA delta over a stacked adapter bank.

``sgmv_apply`` launches the CUDA SGMV (``csrc/sgmv.cu``) for CUDA tensors,
and takes the plain version (``ref.sgmv_ref``) only for CPU tensors.
There is no sort or segment padding.  In bfloat16 it is one kernel: the
rows are cut into tiles of ``TILE_M`` consecutive rows, a tile runs one
pass per distinct adapter (so an adapter's slab is read once per tile,
not once per row), a cluster of CTAs splits the input features for the
shrink on the tensor cores, adds its partials in shared memory and
expands its share of the output columns; the library picks the cluster
size and the copies over the outputs (``sgmv_plan`` in the C library).
float32 keeps the first version's two CUDA-core kernels (``F32_SLICE``
features per shrink CTA, float32 partials in device memory between them).
Out-of-range adapter ids give an exact zero row.

``sgmv_apply.launches`` counts calls that launched the kernels; ``work``
gives the FLOPs and bytes its bound counts.  On meta tensors the wrapper
returns an output of the kernels' shape and computes nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.sgmv.ref import sgmv_ref

TILE_M = 64              # rows per tile (csrc/sgmv.cu kTileM)
MAX_RANK = 16            # largest rank of the bf16 kernel (kRank)
F32_SLICE = 128          # float32: input features per shrink CTA
_MAX_RANK_F32 = 256      # float32 shrink: one rank column per thread group


def sgmv_apply(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               idx: torch.Tensor, *, scaling: float = 1.0) -> torch.Tensor:
    """Unsorted multi-LoRA projection.  x: (R, D); a: (N, D, r);
    b: (N, r, O); idx: (R,) int32 adapter per row.  Returns (R, O) in
    x's dtype."""
    R, D = x.shape
    N, Da, r = a.shape
    if Da != D or b.shape[:2] != (N, r) or idx.shape != (R,):
        raise ValueError(f"sgmv shapes: x {tuple(x.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, idx "
                         f"{tuple(idx.shape)}")
    kind = cuda_lib.device_kind(x, a, b, idx)
    if kind == "cpu":
        return sgmv_ref(x, a, b, idx, scaling=scaling)
    if kind == "meta":
        return cuda_lib.meta_call(
            "sgmv", work(x, a, b, idx),
            torch.empty((R, b.shape[2]), dtype=x.dtype, device=x.device))
    cuda_lib.refuse_autograd("sgmv", x, a, b)
    code = cuda_lib.dtype_code(x, a, b)
    cuda_lib.require_int32(idx)
    cuda_lib.require_contiguous(x=x, a=a, b=b, idx=idx)
    O = b.shape[2]
    if x.dtype == torch.bfloat16:
        if D % 8 or O % 8:
            raise ValueError(f"sgmv bf16 kernel copies 16 bytes at a time: "
                             f"D = {D} and O = {O} must be multiples of 8")
        if r % 8 or not 8 <= r <= MAX_RANK:
            raise ValueError(f"sgmv bf16 kernel takes rank 8 or 16 "
                             f"(multiples of 8 up to {MAX_RANK}), got {r}")
        cuda_lib.require_aligned(x=x, a=a, b=b)
    elif not 1 <= r <= _MAX_RANK_F32:
        raise ValueError(f"sgmv float32 kernel supports rank "
                         f"1..{_MAX_RANK_F32}, got {r}")
    y = torch.empty((R, O), dtype=x.dtype, device=x.device)
    if R == 0:
        return y
    part = None                      # bf16: no scratch
    if x.dtype == torch.float32:
        part = torch.empty((R, -(-D // F32_SLICE), r), dtype=torch.float32,
                           device=x.device)
    cuda_lib.check(cuda_lib.library().sgmv(
        x.data_ptr(), a.data_ptr(), b.data_ptr(), idx.data_ptr(),
        None if part is None else part.data_ptr(), y.data_ptr(), R, D, r, O,
        N, F32_SLICE, float(scaling), code, cuda_lib.stream_of(x)), "sgmv")
    sgmv_apply.launches += 1
    return y


sgmv_apply.launches = 0


def work(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
         idx: torch.Tensor) -> cuda_lib.Work:
    """Bytes: x and y once, idx, each adapter some row uses once (A and
    B); operations: 2 r (D + O) per row with an in-range adapter (the
    others are exact zeros).  On the meta device (ids unknown) every row
    is in range and min(N, R) adapters are used."""
    R, D = x.shape
    N, _, r = a.shape
    O = b.shape[2]
    if idx.device.type == "meta":
        valid, used = R, min(N, R)
    else:
        ok = (idx >= 0) & (idx < N)
        valid, used = int(ok.sum()), int(torch.unique(idx[ok]).numel())
    es = x.element_size()
    return cuda_lib.Work(flops=2 * valid * r * (D + O),
                         bytes=es * (R * D + used * r * (D + O) + R * O)
                         + 4 * R, dtype=x.dtype)


def sgmv_tokens(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                idx: torch.Tensor, **kw) -> torch.Tensor:
    """Token-major wrapper: x (B, T, D) -> (B, T, O).  ``idx`` is (B,),
    one adapter per request that every token of it uses, or (B * T,)
    already expanded per token (``models/transformer.py::_run_stack``
    expands it once per dispatch rather than at every LoRA site)."""
    B, T, D = x.shape
    if T > 1 and idx.shape == (B,):
        idx = idx[:, None].expand(B, T).contiguous().view(B * T)
    elif idx.shape != (B * T,):
        raise ValueError(f"sgmv_tokens: idx {tuple(idx.shape)} for x "
                         f"{tuple(x.shape)}")
    y = sgmv_apply(x.reshape(B * T, D), a, b, idx, **kw)
    return y.reshape(B, T, -1)
