"""``SimResult``: the request-record container the serving replay returns.

Port of the dataclass alone from ``repro/serverless/simulator.py`` (the
discrete-event simulator itself is not ported yet), so
``serving.replay`` can return results comparable with the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.serverless.batching import Request


@dataclasses.dataclass
class SimResult:
    policy: str
    requests: List[Request]
    dollars: float
    gpu_byte_s: float
    sched_overhead_s: float = 0.0

    # ---- metrics ----
    def _ok(self):
        return [r for r in self.requests if r.first_token >= 0]

    @property
    def mean_ttft(self) -> float:
        ok = self._ok()
        return sum(r.first_token - r.arrival for r in ok) / max(len(ok), 1)

    @property
    def p99_ttft(self) -> float:
        ok = sorted(r.first_token - r.arrival for r in self._ok())
        return ok[int(0.99 * (len(ok) - 1))] if ok else 0.0

    @property
    def mean_tpot(self) -> float:
        ok = [r for r in self._ok() if r.output_len > 1]
        return sum((r.done - r.first_token) / max(r.output_len - 1, 1)
                   for r in ok) / max(len(ok), 1)

    @property
    def mean_e2e(self) -> float:
        ok = self._ok()
        return sum(r.done - r.arrival for r in ok) / max(len(ok), 1)

    @property
    def slo_violation_rate(self) -> float:
        ok = self._ok()
        if not ok:
            return 1.0
        v = sum(1 for r in ok if (r.first_token - r.arrival) > r.slo_ttft)
        return v / len(ok)

    def breakdown_totals(self) -> Dict[str, float]:
        tot: Dict[str, float] = {}
        for r in self.requests:
            for k, v in r.breakdown.items():
                tot[k] = tot.get(k, 0.0) + v
        return tot
