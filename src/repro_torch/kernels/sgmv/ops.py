"""SGMV wrappers: per-row multi-LoRA delta over a stacked adapter bank.

``sgmv_apply`` launches the two-kernel CUDA SGMV (``csrc/sgmv.cu``:
shrink into float32 partials of ``xa`` over ``D_CHUNK``-wide slices of the
input features, then expand) for CUDA tensors, and takes
the plain version (``ref.sgmv_ref``) only for CPU tensors.  There is no
sort or segment padding: the kernels gather each row's adapter slab
themselves.  Out-of-range adapter ids give an exact zero row.

``sgmv_apply.launches`` counts calls that launched the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.sgmv.ref import sgmv_ref

_MAX_RANK = 256          # shrink kernel: one rank column per thread group
D_CHUNK = 128            # input features per shrink CTA


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
    if not cuda_lib.on_cuda(x, a, b, idx):
        return sgmv_ref(x, a, b, idx, scaling=scaling)
    code = cuda_lib.dtype_code(x, a, b)
    cuda_lib.require_int32(idx)
    cuda_lib.require_contiguous(x=x, a=a, b=b, idx=idx)
    if not 1 <= r <= _MAX_RANK:
        raise ValueError(f"sgmv kernel supports rank 1..{_MAX_RANK}, got {r}")
    O = b.shape[2]
    y = torch.empty((R, O), dtype=x.dtype, device=x.device)
    if R == 0:
        return y
    S = -(-D // D_CHUNK)
    part = torch.empty((R, S, r), dtype=torch.float32, device=x.device)
    lib = cuda_lib.library()
    stream = cuda_lib.stream_of(x)
    cuda_lib.check(lib.sgmv_shrink(x.data_ptr(), a.data_ptr(),
                                   idx.data_ptr(), part.data_ptr(), R, D, r,
                                   N, D_CHUNK, code, stream), "sgmv_shrink")
    cuda_lib.check(lib.sgmv_expand(part.data_ptr(), b.data_ptr(),
                                   idx.data_ptr(), y.data_ptr(), R, r, O, N,
                                   S, float(scaling), code, stream),
                   "sgmv_expand")
    sgmv_apply.launches += 1
    return y


sgmv_apply.launches = 0


def sgmv_tokens(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                idx: torch.Tensor, **kw) -> torch.Tensor:
    """Token-major wrapper: x (B, T, D) -> (B, T, O).  ``idx`` is (B,),
    one adapter per request that every token of it uses, or (B * T,)
    already expanded per token (``models/transformer.py::_run_stack``
    expands it once per dispatch rather than at every LoRA site)."""
    B, T, D = x.shape
    if T > 1 and idx.shape == (B,):
        idx = idx.repeat_interleave(T)
    elif idx.shape != (B * T,):
        raise ValueError(f"sgmv_tokens: idx {tuple(idx.shape)} for x "
                         f"{tuple(x.shape)}")
    y = sgmv_apply(x.reshape(B * T, D), a, b, idx, **kw)
    return y.reshape(B, T, -1)
