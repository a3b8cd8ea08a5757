"""Frozen counts of one paged prefill launch (the program's
``kernels/paged_prefill/ops.py::work``), on the host from the dispatch's
inputs.

Bytes: q and the output, K and V of each history key the chunk sees once,
the table and the positions; operations: 4 hd per visible (query, key) pair
and query head.  Every query of the chunk counts, the tail past a prompt's
end included: the launch is given them.  Keys are counted block by block.
"""
from typing import Optional, Tuple

import numpy as np


def _keys_in(tbl, lo, hi, bs):
    j = np.arange(tbl.shape[1])
    first, last = j * bs, j * bs + bs - 1
    n = (np.minimum(last, hi[..., None]) - np.maximum(first, lo[..., None])
         + 1)
    alloc = (tbl >= 0).reshape(tbl.shape[:1] + (1,) * (hi.ndim - 1)
                               + tbl.shape[1:])
    return (np.clip(n, 0, bs) * alloc).sum(axis=-1)


def work(tbl: np.ndarray, start: np.ndarray, chunk: int, *, heads: int,
         kv_heads: int, head_dim: int, block_size: int, elem_bytes: int,
         window: Optional[int] = None) -> Tuple[float, float]:
    """(operations, bytes) of one launch of rows ``tbl`` (B, MB) whose
    chunks start at ``start`` (B,) and hold ``chunk`` queries."""
    b, mb = tbl.shape
    start = start.astype(np.int64)
    qp = start[:, None] + np.arange(chunk)[None]               # (B, C)
    end = start + chunk - 1
    if window is None:
        pairs = _keys_in(tbl, np.zeros_like(qp), qp, block_size)
        seen = _keys_in(tbl, np.zeros_like(start), end, block_size)
    else:
        pairs = _keys_in(tbl, qp - window + 1, qp, block_size)
        seen = _keys_in(tbl, start - window + 1, end, block_size)
    flops = 4 * head_dim * heads * int(pairs.sum())
    nbytes = (elem_bytes * (2 * int(seen.sum()) * kv_heads * head_dim
                            + 2 * b * chunk * heads * head_dim)
              + 4 * (b * mb + b * chunk))
    return float(flops), float(nbytes)
