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

Everything is data: the per-row vectors are tensors on the logits'
device, every row computes both its greedy and its sampled token and
``torch.where`` picks one, and the Philox draw runs as torch ops on int64
tensors.  So one captured graph serves any mix of modes, with no host
branch and no host copy inside the step.  ``philox_uniform`` (numpy) is
the draw's plain version, which the tests hold ``philox_uniform_torch``
to bit for bit.
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
_MASK32 = 0xFFFFFFFF


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


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32)
    and a 32-bit constant ``m``.  int64 cannot hold a full 64-bit product,
    so ``m`` is split into 16-bit limbs: no partial product exceeds 2^48."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox_uniform_torch(seed: torch.Tensor,
                         counter: torch.Tensor) -> torch.Tensor:
    """``philox_uniform`` as torch ops on the inputs' device: seeds and
    counters of one shape (int32 or int64, read as 32-bit words) -> float32
    uniforms in [0, 1) of that shape, bit for bit the numpy draw."""
    k0 = seed.long() & _MASK32
    c0 = counter.long() & _MASK32
    c1 = c2 = c3 = torch.zeros_like(c0)
    k1 = 0
    for i in range(10):
        if i:
            k0 = (k0 + int(_W0)) & _MASK32
            k1 = (k1 + int(_W1)) & _MASK32
        hi0, lo0 = _mulhilo(c0, int(_M0))
        hi1, lo1 = _mulhilo(c2, int(_M1))
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return (c0 >> 8).to(torch.float32) * (2.0 ** -24)


def keep_mask(sorted_scaled: torch.Tensor, top_k: torch.Tensor,
              top_p: torch.Tensor) -> torch.Tensor:
    """Boolean keep-mask over descending-sorted (temperature-scaled)
    logits: rank < k_eff AND cumulative mass *before* the rank < p_eff.
    ``top_k <= 0`` / ``top_p >= 1`` disable their filter; rank 0 always
    survives both, so the mask is never empty."""
    V = sorted_scaled.shape[-1]
    ranks = torch.arange(V, device=sorted_scaled.device, dtype=torch.int32)
    k_eff = torch.where(top_k <= 0, V, torch.clamp(top_k, max=V))
    mask_k = ranks[None, :] < k_eff[:, None]
    probs = torch.softmax(sorted_scaled, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    p_eff = torch.where(top_p >= 1.0, 2.0, top_p).to(probs.dtype)
    mask_p = before < p_eff[:, None]
    return mask_k & mask_p


def _sorted_masked(logits: torch.Tensor, temperature: torch.Tensor, top_k,
                   top_p):
    """Temperature-scaled logits sorted descending (stable), with the
    keep-mask applied: returns (order, masked sorted logits, keep).  Greedy
    rows divide by 1."""
    t_safe = torch.where(temperature > 0.0, temperature, 1.0).to(
        torch.float32)
    scaled = logits.float() / t_safe[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_scaled = torch.gather(scaled, -1, order)
    keep = keep_mask(sorted_scaled, top_k, top_p)
    return order, sorted_scaled.masked_fill(~keep, float("-inf")), keep


def sample_with_uniform(logits: torch.Tensor, temperature: torch.Tensor,
                        top_k: torch.Tensor, top_p: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """(B, V) logits + per-row sampling tensors + (B,) uniforms -> (B,)
    int32 tokens.  Every row computes both tokens: ``temperature <= 0``
    rows keep ``argmax`` of the RAW logits, sampled rows the inverse-CDF
    draw of ``u`` over their masked distribution."""
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    order, masked, keep = _sorted_masked(logits, temperature, top_k, top_p)
    cdf = torch.cumsum(torch.softmax(masked, dim=-1), dim=-1)
    pos = torch.searchsorted(cdf, u[:, None], right=True)[:, 0]
    # rounding can leave the last cdf entry a hair below u: stay inside
    # the kept prefix
    pos = torch.minimum(pos, keep.sum(dim=-1) - 1)
    sampled = torch.gather(order, -1, pos[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0.0, sampled, greedy_tok)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  seed: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """(B, V) logits + per-row sampling tensors -> (B,) int32 tokens; the
    uniform of a sampled row is its ``(seed, counter)`` Philox draw."""
    return sample_with_uniform(logits, temperature, top_k, top_p,
                               philox_uniform_torch(seed, counter))


def sampling_distribution(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor,
                          top_p: torch.Tensor) -> torch.Tensor:
    """The exact per-row categorical distribution ``sample_tokens`` draws
    from, in ORIGINAL vocab order (greedy rows: one-hot at argmax)."""
    order, masked, _ = _sorted_masked(logits, temperature, top_k, top_p)
    probs_sorted = torch.softmax(masked, dim=-1)
    probs = torch.zeros_like(probs_sorted).scatter_(-1, order, probs_sorted)
    onehot = torch.nn.functional.one_hot(
        torch.argmax(logits, dim=-1), logits.shape[-1]).to(probs.dtype)
    return torch.where((temperature > 0.0)[:, None], probs, onehot)
