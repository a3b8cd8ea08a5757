"""Frozen counts of one SGMV launch (copied from the program's
``kernels/sgmv/ops.py::work``), on the host from the dispatch's inputs.

Bytes: x and y once, the ids, each adapter some row uses once (A and B);
operations: 2 r (D + O) per row with an in-range adapter.
"""
from typing import Tuple

import numpy as np


def work(idx: np.ndarray, *, d_in: int, d_out: int, rank: int,
         bank: int, elem_bytes: int) -> Tuple[float, float]:
    """(operations, bytes) of one launch over rows with adapter ids
    ``idx`` (R,) into a bank of ``bank`` adapters."""
    r_rows = int(idx.shape[0])
    ok = (idx >= 0) & (idx < bank)
    valid = int(ok.sum())
    used = int(np.unique(idx[ok]).size)
    flops = 2 * valid * rank * (d_in + d_out)
    nbytes = (elem_bytes * (r_rows * d_in + used * rank * (d_in + d_out)
                            + r_rows * d_out) + 4 * r_rows)
    return float(flops), float(nbytes)
