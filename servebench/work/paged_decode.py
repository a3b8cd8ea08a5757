"""Frozen counts of one paged decode launch (the program's
``kernels/paged_attention/ops.py::work``), on the host from the dispatch's
inputs.

Bytes: q and the output, K and V of each live key once, the table and the
positions; operations: 4 hd per live key and query head.  A key at position
t of row b is live when t <= pos[b], its block is allocated and t is inside
the window.  Keys are counted block by block.
"""
from typing import Optional, Tuple

import numpy as np


def _keys_in(tbl, lo, hi, bs):
    """Per row, the allocated keys t with lo <= t <= hi."""
    j = np.arange(tbl.shape[1])
    first, last = j * bs, j * bs + bs - 1
    n = (np.minimum(last, hi[:, None]) - np.maximum(first, lo[:, None])
         + 1)
    return (np.clip(n, 0, bs) * (tbl >= 0)).sum(axis=-1)


def live_keys(tbl: np.ndarray, pos: np.ndarray, bs: int,
              window: Optional[int] = None) -> int:
    lo = np.zeros_like(pos) if window is None else pos - window + 1
    return int(_keys_in(tbl, lo, pos, bs).sum())


def work(tbl: np.ndarray, pos: np.ndarray, *, heads: int, kv_heads: int,
         head_dim: int, block_size: int, elem_bytes: int,
         window: Optional[int] = None) -> Tuple[float, float]:
    """(operations, bytes) of one launch over rows ``tbl`` (B, MB) at
    positions ``pos`` (B,)."""
    b, mb = tbl.shape
    live = live_keys(tbl, pos.astype(np.int64), block_size, window)
    flops = 4 * head_dim * heads * live
    nbytes = (elem_bytes * (2 * live * kv_heads * head_dim
                            + 2 * b * heads * head_dim) + 4 * (b * mb + b))
    return float(flops), float(nbytes)
