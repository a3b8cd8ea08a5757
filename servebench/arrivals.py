"""Draws of arrival gaps, lengths and function popularity.

Every draw is stratified: a fixed number of values taken at the quantiles
(i + 0.5) / n of their distribution and put in an order drawn from the
seed.  Every seed then gets the same set of gaps and lengths, and so the
same work, in another order: runs on different seeds differ by order and
by token content alone.
"""
from __future__ import annotations

import math
import statistics
from typing import List, Sequence

import numpy as np


def midpoints(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def exponential_quantiles(n: int, mean: float) -> np.ndarray:
    """The n gaps of a Poisson process of this mean gap, stratified."""
    return -mean * np.log1p(-midpoints(n))


def lognormal_quantiles(n: int, median: float, sigma: float, lo: int,
                        hi: int) -> np.ndarray:
    """n whole lengths, lognormal about ``median``, clipped to [lo, hi]."""
    z = np.array([statistics.NormalDist().inv_cdf(float(u))
                  for u in midpoints(n)])
    v = np.exp(math.log(median) + sigma * z)
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def zipf_shares(k: int, s: float) -> np.ndarray:
    w = 1.0 / np.arange(1, k + 1) ** s
    return w / w.sum()


def apportion(n: int, shares: Sequence[float]) -> List[int]:
    """Whole counts summing to n in proportion to ``shares`` (largest
    remainder; ties to the lower index)."""
    raw = np.asarray(shares, dtype=np.float64) * n
    base = np.floor(raw).astype(np.int64)
    left = n - int(base.sum())
    order = sorted(range(len(raw)), key=lambda i: (-(raw[i] - base[i]), i))
    for i in order[:left]:
        base[i] += 1
    return [int(c) for c in base]


def function_sequence(n: int, shares: Sequence[float],
                      rng: np.random.Generator) -> np.ndarray:
    """n function ids whose counts follow ``shares``, in a seeded order."""
    ids = np.concatenate([np.full(c, i, dtype=np.int64)
                          for i, c in enumerate(apportion(n, shares))])
    return rng.permutation(ids)
