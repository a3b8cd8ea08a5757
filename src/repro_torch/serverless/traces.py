"""Azure-Functions-like arrival traces (paper §6.1).

The paper buckets traces by the coefficient of variation (CoV) of request
inter-arrival times: Predictable (CoV ≤ 1), Normal (1 < CoV ≤ 4), Bursty
(CoV > 4).  We generate gamma-renewal arrivals with shape k = 1/CoV² —
k = 1 is Poisson (CoV 1), k < 1 is over-dispersed/bursty — plus an optional
diurnal rate modulation to mimic the 14-day Azure shape.  Deterministic via
seeded numpy Generators.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Dict, List, Sequence

import numpy as np

PATTERNS = {
    "predictable": 0.6,   # CoV
    "normal": 2.5,
    "bursty": 6.0,
}


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    fn_id: str
    pattern: str              # predictable | normal | bursty
    mean_rate: float          # requests / s
    duration_s: float
    prompt_len: int = 512
    output_len: int = 64
    slo_ttft: float = 2.5


def gen_arrivals(spec: TraceSpec, seed: int = 0) -> np.ndarray:
    """Gamma-renewal arrival times in [0, duration]."""
    # stable digest, NOT hash(): str hashing is salted per process, which
    # would make "seeded" traces differ from one run to the next
    fn_digest = zlib.crc32(spec.fn_id.encode()) & 0x7FFFFFFF
    rng = np.random.default_rng(seed ^ fn_digest)
    cov = PATTERNS[spec.pattern]
    k = 1.0 / (cov * cov)
    mean_gap = 1.0 / spec.mean_rate
    n_est = int(spec.duration_s * spec.mean_rate * 2.5) + 16
    gaps = rng.gamma(shape=k, scale=mean_gap / k, size=n_est)
    t = np.cumsum(gaps)
    t = t[t < spec.duration_s]
    # diurnal-ish modulation by thinning (keeps renewal CoV roughly intact)
    phase = rng.uniform(0, 2 * math.pi)
    keep = rng.uniform(size=t.shape) < 0.65 + 0.35 * np.sin(
        2 * math.pi * t / max(spec.duration_s, 1.0) + phase)
    return t[keep]


def measured_cov(arrivals: np.ndarray) -> float:
    gaps = np.diff(arrivals)
    if len(gaps) < 2:
        return 0.0
    return float(np.std(gaps) / max(np.mean(gaps), 1e-12))


def make_workload(specs: Sequence[TraceSpec], seed: int = 0
                  ) -> List[Dict]:
    """Merged, time-sorted request dicts for the simulator."""
    events = []
    rid = 0
    for i, spec in enumerate(specs):
        for t in gen_arrivals(spec, seed + i * 1009):
            events.append({
                "req_id": rid, "fn_id": spec.fn_id, "arrival": float(t),
                "prompt_len": spec.prompt_len, "output_len": spec.output_len,
                "slo_ttft": spec.slo_ttft,
            })
            rid += 1
    events.sort(key=lambda e: e["arrival"])
    for i, e in enumerate(events):
        e["req_id"] = i
    return events
