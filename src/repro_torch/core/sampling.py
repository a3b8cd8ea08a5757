"""Per-slot seeded sampling (port of ``repro/core/sampling.py``).

Sampling parameters ride each dispatch as per-row DATA: ``temperature`` /
``top_k`` / ``top_p`` vectors plus ``(seed, counter)`` key material, so a
batch mixing greedy and sampled rows runs through the same step.

* ``temperature <= 0`` rows take the EXACT greedy path: ``argmax`` of the
  raw logits, first index on ties.
* Sampled rows draw by inverse CDF over the top-k/top-p-masked,
  temperature-scaled distribution, with a uniform from a counter-based
  Philox4x32-10 generator keyed by ``(seed, counter)``: the token at
  output position ``i`` is a pure function of ``(seed, i, logits)``, as in
  the reference.  The bits cannot match the reference's threefry keys, so
  ``keep_mask`` and ``sampling_distribution`` are what is held against
  it.

The per-row vectors are host numpy arrays (the runtime's slot mirrors):
an all-greedy batch then skips the sampling work without reading anything
back from the device, and the Philox draw runs on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

MODES = ("greedy", "temperature", "top_k", "top_p", "top_kp")

_SEED_MASK = 0x7FFFFFFF


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling policy (the ``ServeRequest.sampling`` field).

    ``temperature <= 0`` (the default) is EXACT greedy.  ``top_k <= 0``
    disables the top-k filter; ``top_p >= 1`` disables the nucleus
    filter; both filters always keep at least the most-likely token."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None

    def __post_init__(self):
        if not self.temperature >= 0.0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def mode(self) -> str:
        """One of ``MODES`` — the per-mode token-counter key."""
        if self.greedy:
            return "greedy"
        k, p = self.top_k > 0, self.top_p < 1.0
        if k and p:
            return "top_kp"
        if k:
            return "top_k"
        if p:
            return "top_p"
        return "temperature"

    def resolve_seed(self, req_id: int) -> int:
        """The int32 seed: the explicit seed when given, else the request
        id (masked non-negative)."""
        s = self.seed if self.seed is not None else int(req_id)
        return int(s) & _SEED_MASK


GREEDY = SamplingParams()

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
_LO = np.uint64(0xFFFFFFFF)


def philox_uniform(seed, counter) -> np.ndarray:
    """(B,) seeds + (B,) counters -> (B,) float32 uniforms in [0, 1).

    Philox4x32-10 with key ``(seed, 0)`` and counter ``(counter, 0, 0,
    0)``; the first output word's top 24 bits make the uniform.  32x32-bit
    products fit exactly in uint64, so the arithmetic is exact."""
    k0 = np.asarray(seed, np.int64).astype(np.uint64) & _LO
    k1 = np.zeros_like(k0)
    c0 = np.asarray(counter, np.int64).astype(np.uint64) & _LO
    c1 = np.zeros_like(c0)
    c2 = np.zeros_like(c0)
    c3 = np.zeros_like(c0)
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _LO
            k1 = (k1 + _W1) & _LO
        p0 = _M0 * c0
        p1 = _M1 * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & _LO,
                          (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & _LO)
    return ((c0 >> np.uint64(8)).astype(np.float32)
            * np.float32(2.0 ** -24))


def keep_mask(sorted_scaled: torch.Tensor, top_k, top_p) -> torch.Tensor:
    """Boolean keep-mask over descending-sorted (temperature-scaled)
    logits: rank < k_eff AND cumulative mass *before* the rank < p_eff.
    ``top_k <= 0`` / ``top_p >= 1`` disable their filter; rank 0 always
    survives both, so the mask is never empty."""
    dev = sorted_scaled.device
    V = sorted_scaled.shape[-1]
    top_k = torch.as_tensor(top_k, device=dev)
    top_p = torch.as_tensor(top_p, device=dev)
    ranks = torch.arange(V, device=dev, dtype=torch.int32)
    k_eff = torch.where(top_k <= 0, V, torch.clamp(top_k, max=V))
    mask_k = ranks[None, :] < k_eff[:, None]
    probs = torch.softmax(sorted_scaled, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    p_eff = torch.where(top_p >= 1.0, 2.0, top_p).to(probs.dtype)
    mask_p = before < p_eff[:, None]
    return mask_k & mask_p


def _sorted_masked(logits: torch.Tensor, temperature: np.ndarray, top_k,
                   top_p):
    """Temperature-scaled logits sorted descending (stable), with the
    keep-mask applied: returns (order, masked sorted logits, keep)."""
    t_safe = np.where(temperature > 0.0, temperature, 1.0).astype(np.float32)
    scaled = logits.float() / torch.as_tensor(t_safe,
                                              device=logits.device)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_scaled = torch.gather(scaled, -1, order)
    keep = keep_mask(sorted_scaled, top_k, top_p)
    return order, sorted_scaled.masked_fill(~keep, float("-inf")), keep


def sample_tokens(logits: torch.Tensor, temperature, top_k, top_p, seed,
                  counter) -> torch.Tensor:
    """(B, V) logits + per-row host sampling vectors -> (B,) int32 tokens.

    Rows with ``temperature <= 0`` emit ``argmax`` of the RAW logits;
    sampled rows draw from the masked distribution with the row's
    ``(seed, counter)`` uniform."""
    temperature = np.asarray(temperature, np.float32)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    hot = temperature > 0.0
    if not hot.any():
        return greedy_tok
    dev = logits.device
    order, masked, keep = _sorted_masked(logits, temperature, top_k, top_p)
    cdf = torch.cumsum(torch.softmax(masked, dim=-1), dim=-1)
    u = torch.as_tensor(philox_uniform(seed, counter), device=dev)
    pos = torch.searchsorted(cdf, u[:, None], right=True)[:, 0]
    # rounding can leave the last cdf entry a hair below u: stay inside
    # the kept prefix
    pos = torch.minimum(pos, keep.sum(dim=-1) - 1)
    sampled = torch.gather(order, -1, pos[:, None])[:, 0].to(torch.int32)
    return torch.where(torch.as_tensor(hot, device=dev), sampled, greedy_tok)


def sampling_distribution(logits: torch.Tensor, temperature, top_k,
                          top_p) -> torch.Tensor:
    """The exact per-row categorical distribution ``sample_tokens`` draws
    from, in ORIGINAL vocab order (greedy rows: one-hot at argmax)."""
    temperature = np.asarray(temperature, np.float32)
    order, masked, _ = _sorted_masked(logits, temperature, top_k, top_p)
    probs_sorted = torch.softmax(masked, dim=-1)
    probs = torch.zeros_like(probs_sorted).scatter_(-1, order, probs_sorted)
    onehot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).to(probs.dtype)
    hot = torch.as_tensor(temperature > 0.0, device=logits.device)
    return torch.where(hot[:, None], probs, onehot)
