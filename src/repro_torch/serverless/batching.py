"""Adaptive Batching Scheduler (paper §4.2).

Local level — fill-or-expire per function:
    T_i(b) = T0_i + α_i (b − 1)              (Eq. 2, from offline profiling;
                                              we derive T0/α from the roofline)
    B_i   = max b s.t. T_i(b) ≤ SLO_i        (max batch within SLO)
    d_i   = SLO_i − T_i(N_i)                 (Eq. 3, max extra wait)

Global level — deadline-margin priority under contention (Eq. 4/5):
    T_eff = M · T_i(b);  Δ_i = SLO_i − (w_i + M · T_i(b))
Batches with the smallest margin dispatch first.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.serverless.latency import LatencyModel
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    req_id: int
    fn_id: str
    arrival: float
    prompt_len: int
    output_len: int
    slo_ttft: float
    # SLO class + hard deadlines (serving.runtime deadline-aware admission;
    # the simulator ignores them).  slo_class orders preemption: a HIGHER
    # class may preempt a lower one; deadlines are absolute budgets from
    # arrival — inf (the default) disables shedding entirely, so traces
    # that never set them replay bitwise-identically to before the fields
    # existed.
    slo_class: int = 0
    deadline_ttft: float = float("inf")
    deadline_e2e: float = float("inf")
    # filled by the simulator
    dispatch: float = -1.0
    first_token: float = -1.0
    done: float = -1.0
    cold_start: float = 0.0
    breakdown: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BatchProfile:
    t0: float
    alpha: float
    max_batch: int

    def t(self, b: int) -> float:
        return self.t0 + self.alpha * (b - 1)


def profile_function(cfg: ModelConfig, prompt_len: int, slo: float,
                     lat: LatencyModel, *, mem_cap_batch: int = 1 << 30
                     ) -> BatchProfile:
    """Offline profiling stand-in: derive (T0, α, B_max) from the roofline."""
    t0, alpha = lat.prefill_t0_alpha(cfg, prompt_len)
    if t0 >= slo:
        bmax = 1
    else:
        bmax = int((slo - t0) / alpha) + 1
    return BatchProfile(t0, alpha, max(1, min(bmax, mem_cap_batch)))


class FunctionQueue:
    """Fill-or-expire queue for one function."""

    def __init__(self, fn_id: str, profile: BatchProfile):
        self.fn_id = fn_id
        self.profile = profile
        self.pending: List[Request] = []

    def push(self, req: Request) -> None:
        self.pending.append(req)

    def push_front(self, reqs: List[Request]) -> None:
        """Requeue (e.g. saturated chip) preserving arrival order."""
        self.pending[:0] = reqs

    def expire_deadline(self, now: float, *, cap: float = float("inf")
                        ) -> Optional[float]:
        """Absolute time the current batch must dispatch, or None.

        Eq. 3 gives the *maximum* delay d = SLO − T(N); waiting that long on
        a warm instance would push every TTFT to the SLO, so the scheduler
        additionally caps the delay: tiny when the function is warm (nothing
        to amortize), longer when cold (requests batched while artifacts
        load anyway). The cap is supplied by the platform (warm hint)."""
        if not self.pending:
            return None
        # queues are arrival-ordered (push appends in time order; requeues
        # prepend), so the head is the oldest — O(1) under deep backlogs
        oldest = self.pending[0].arrival
        slo = self.pending[0].slo_ttft
        d = slo - self.profile.t(len(self.pending))
        return oldest + max(min(d, cap), 0.0)

    def full(self) -> bool:
        return len(self.pending) >= self.profile.max_batch

    def pop_batch(self) -> List[Request]:
        b = self.pending[: self.profile.max_batch]
        self.pending = self.pending[self.profile.max_batch:]
        return b

    def deadline_margin(self, now: float, concurrency: int) -> float:
        """Δ_i (Eq. 5) of the would-be batch at current queue size."""
        if not self.pending:
            return float("inf")
        b = min(len(self.pending), self.profile.max_batch)
        w = now - self.pending[0].arrival
        slo = self.pending[0].slo_ttft
        return slo - (w + max(concurrency, 1) * self.profile.t(b))


class BatchingScheduler:
    """Two-layer scheduler over all function queues."""

    WARM_CAP = 0.05      # s — dispatch almost immediately on warm instances
    COLD_CAP = 1.0       # s — batch up while artifacts are loading

    def __init__(self, adaptive: bool = True,
                 fixed_batch: int = 1, fixed_delay: float = 0.0):
        self.queues: Dict[str, FunctionQueue] = {}
        self.adaptive = adaptive
        self.fixed_batch = fixed_batch
        self.fixed_delay = fixed_delay
        # platform hints: warm instance available? expected arrival rate?
        self.warm_hint = lambda fn_id: True
        self.rate_hint = lambda fn_id: 1.0

    def _cap(self, fn_id: str) -> float:
        if self.warm_hint(fn_id):
            return self.WARM_CAP
        # cold: batching amortizes the load — but only wait if another
        # request is actually expected within the cold window
        if self.rate_hint(fn_id) >= 1.0 / self.COLD_CAP:
            return self.COLD_CAP
        return self.WARM_CAP

    def register(self, fn_id: str, profile: BatchProfile) -> None:
        if not self.adaptive:
            profile = BatchProfile(profile.t0, profile.alpha,
                                   self.fixed_batch)
        self.queues[fn_id] = FunctionQueue(fn_id, profile)

    def push(self, req: Request) -> None:
        self.queues[req.fn_id].push(req)

    def next_timer(self, now: float) -> Optional[float]:
        """Earliest fill-or-expire deadline across queues."""
        ts = []
        for q in self.queues.values():
            if not q.pending:
                continue
            if self.adaptive:
                t = q.expire_deadline(now, cap=self._cap(q.fn_id))
            else:
                t = q.pending[0].arrival + self.fixed_delay
            if t is not None:
                ts.append(t)
        return min(ts) if ts else None

    def ready_queues(self, now: float) -> List[FunctionQueue]:
        """Queues that must dispatch now (full, or deadline expired)."""
        out = []
        for q in self.queues.values():
            if not q.pending:
                continue
            if q.full():
                out.append(q)
                continue
            if self.adaptive:
                dl = q.expire_deadline(now, cap=self._cap(q.fn_id))
                if dl is not None and now >= dl - 1e-9:
                    out.append(q)
            else:
                if now >= q.pending[0].arrival + self.fixed_delay:
                    out.append(q)
        # global layer: smallest deadline margin first
        if self.adaptive:
            out.sort(key=lambda q: q.deadline_margin(now, 1))
        return out
