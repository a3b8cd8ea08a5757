"""Decode-slot table and SLO admission scheduling.

A *slot* is one row of the fixed-shape decode batch.  The table keeps the
host-side mirror of the device state (next write position, block table,
adapter) plus per-request bookkeeping (token budget, produced tokens).

Admission reuses the §4.2 fill-or-expire machinery from
``serverless.batching`` verbatim: each function gets a ``FunctionQueue``
whose ``max_batch`` is the prefill group size, queues dispatch when full or
when Eq. 3's capped deadline expires, and ties break on Eq. 5's deadline
margin.  On top of that the serving layer adds SLO abandonment — a queued
request whose TTFT deadline already passed is dropped instead of admitted.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.sampling import GREEDY, SamplingParams
from repro_torch.serverless.batching import (BatchingScheduler, BatchProfile,
                                       Request)


@dataclasses.dataclass
class SlotState:
    """One in-flight request bound to a decode slot."""
    sid: int
    req: Request
    adapter: int
    prompt_len: int
    budget: int                  # max output tokens (incl. the prefill token)
    pos: int                     # next KV write position (absolute)
    blocks: List[int]            # physical block ids, logical order; -1 =
    #   reclaimed (slid fully out of the sliding window, returned to pool)
    last_token: int              # last accepted token (stall replays it)
    produced: int = 1            # tokens emitted so far (prefill emits one)
    stalled: bool = False
    reclaimed: int = 0           # logical blocks [0, reclaimed) returned to
    #   the pool by sliding-window reclamation
    shared: int = 0              # leading blocks mapped from the prefix
    #   cache at admit (refcount bumps, not fresh allocations)
    prompt_tokens: Optional[np.ndarray] = None  # the admitted prompt ids —
    #   kept so preempt/abort can re-index COMPLETED blocks (prompt AND
    #   decoded tokens) into the prefix trie before release, demoting them
    #   to the cached-LRU tier for cheap resume (host ints only; never
    #   touches the device)
    history: List[int] = dataclasses.field(default_factory=list)
    #   accepted output tokens in order (history[0] = the prefill token);
    #   token at absolute position prompt_len + i is history[i], which is
    #   what lets demotion name the token content of decode-written blocks
    sampling: SamplingParams = GREEDY   # per-request sampling policy
    #   (dispatched as per-row data vectors, never a compiled shape)
    seed: int = 0                # resolved int32 PRNG seed; the RNG
    #   counter itself is DERIVED (== produced), so preempt/resume
    #   restores it for free with the slot's history


class SlotTable:
    """Fixed set of decode slots + the numpy mirrors of the device inputs."""

    def __init__(self, num_slots: int, max_blocks: int):
        self.num_slots = num_slots
        self.max_blocks = max_blocks
        self.states: List[Optional[SlotState]] = [None] * num_slots
        self.tokens = np.zeros((num_slots,), np.int32)
        self.pos = np.zeros((num_slots,), np.int32)
        self.adapter = np.zeros((num_slots,), np.int32)
        self.block_tbl = np.full((num_slots, max_blocks), -1, np.int32)
        # per-row sampling vectors (dispatch DATA, one compiled shape):
        # inactive rows keep the greedy defaults, so garbage rows always
        # take the argmax path and never consult the RNG
        self.temp = np.zeros((num_slots,), np.float32)
        self.top_k = np.zeros((num_slots,), np.int32)
        self.top_p = np.ones((num_slots,), np.float32)
        self.seed = np.zeros((num_slots,), np.int32)
        self.rng_counter = np.zeros((num_slots,), np.int32)
        #   == tokens generated so far (SlotState.produced); the decode
        #   scan samples counters [c, c + chunk) and the accept loop
        #   re-derives c from produced — stalls (outputs discarded,
        #   produced unchanged) therefore re-dispatch the same counters

    # ------------------------------------------------------------- queries
    def free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.states) if s is None]

    def state_rows(self, garbage_row: int) -> np.ndarray:
        """Per-row REC/SSD state-row ids for the next decode dispatch: an
        active, unstalled slot owns the row of its own sid; inactive AND
        stalled rows point at the garbage row, so the chunk they run
        (outputs discarded) cannot advance real recurrent state — KV
        writes are re-written identically by the resume, but a recurrent
        state would advance twice."""
        rows = np.full((self.num_slots,), garbage_row, np.int32)
        for s in self.active():
            if not s.stalled:
                rows[s.sid] = s.sid
        return rows

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.states if s is not None)

    def active(self) -> List[SlotState]:
        return [s for s in self.states if s is not None]

    # ------------------------------------------------------------ mutation
    def bind(self, state: SlotState, first_token: int) -> None:
        sid = state.sid
        assert self.states[sid] is None, f"slot {sid} already bound"
        self.states[sid] = state
        self.tokens[sid] = first_token
        self.pos[sid] = state.pos
        self.adapter[sid] = state.adapter
        self.block_tbl[sid, :] = -1
        self.block_tbl[sid, : len(state.blocks)] = state.blocks
        self.temp[sid] = state.sampling.temperature
        self.top_k[sid] = state.sampling.top_k
        self.top_p[sid] = state.sampling.top_p
        self.seed[sid] = state.seed
        self.rng_counter[sid] = state.produced

    def grow(self, sid: int, block_id: int) -> None:
        s = self.states[sid]
        assert s is not None and len(s.blocks) < self.max_blocks
        self.block_tbl[sid, len(s.blocks)] = block_id
        s.blocks.append(block_id)

    def reclaim(self, sid: int, upto: int) -> List[int]:
        """Drop logical blocks [0, upto) that slid fully out of the sliding
        window: table entries become -1 (the decode mask already never reads
        them) and the physical ids are returned for the pool to release.
        Monotonic and idempotent — already-reclaimed entries are skipped."""
        s = self.states[sid]
        assert s is not None
        upto = min(upto, len(s.blocks))
        freed: List[int] = []
        for j in range(s.reclaimed, upto):
            b = s.blocks[j]
            if b >= 0:
                freed.append(b)
                s.blocks[j] = -1
                self.block_tbl[sid, j] = -1
        s.reclaimed = max(s.reclaimed, upto)
        return freed

    def release(self, sid: int) -> List[int]:
        """Unbind a slot; returns its still-held blocks for the pool to
        release (reclaimed -1 placeholders were already returned)."""
        s = self.states[sid]
        assert s is not None
        self.states[sid] = None
        self.tokens[sid] = 0
        self.pos[sid] = 0
        self.adapter[sid] = 0
        self.block_tbl[sid, :] = -1
        self.temp[sid] = 0.0
        self.top_k[sid] = 0
        self.top_p[sid] = 1.0
        self.seed[sid] = 0
        self.rng_counter[sid] = 0
        return [b for b in s.blocks if b >= 0]


class AdmissionScheduler:
    """Fill-or-expire admission with deadline-margin priority + SLO abandon."""

    def __init__(self, group: int = 2, slo_abandon: bool = True):
        self.group = group
        self.slo_abandon = slo_abandon
        self._sched = BatchingScheduler(adaptive=True)
        self._sched.warm_hint = lambda fn_id: True   # runtime is always warm

    def register(self, fn_id: str, t0: float, alpha: float) -> None:
        """Profile from measured prefill latency (Eq. 2 with b capped at the
        prefill group size — the runtime prefills at most ``group`` rows)."""
        self._sched.register(fn_id, BatchProfile(t0, alpha, self.group))

    def push(self, req: Request) -> None:
        self._sched.push(req)

    @property
    def pending(self) -> int:
        return sum(len(q.pending) for q in self._sched.queues.values())

    def next_timer(self, now: float) -> Optional[float]:
        return self._sched.next_timer(now)

    def abandon_expired(self, now: float) -> List[Request]:
        """Drop queued requests whose TTFT SLO already lapsed (§4.2: serving
        them would burn slot time on a guaranteed violation)."""
        if not self.slo_abandon:
            return []
        dropped: List[Request] = []
        for q in self._sched.queues.values():
            keep = []
            for r in q.pending:
                if now - r.arrival > r.slo_ttft:
                    r.breakdown["abandoned"] = now - r.arrival
                    dropped.append(r)
                else:
                    keep.append(r)
            q.pending = keep
        return dropped

    def requeue_front(self, reqs: List[Request]) -> None:
        """Put an unadmittable batch back at the head of its queue (resource
        shortage is not the requests' fault; arrival order is preserved)."""
        if reqs:
            self._sched.queues[reqs[0].fn_id].push_front(reqs)

    def pop_ready(self, now: float, max_requests: int) -> List[Request]:
        """Highest-priority ready group, at most ``max_requests`` requests.
        Leftovers (slot shortage) stay queued at the front, order preserved."""
        if max_requests <= 0:
            return []
        for q in self._sched.ready_queues(now):
            batch = q.pop_batch()
            if not batch:
                continue
            if len(batch) > max_requests:
                q.push_front(batch[max_requests:])
                batch = batch[:max_requests]
            return batch
        return []

    def pending_requests(self) -> List[Request]:
        """Every queued request (all functions, queue order) — the replay
        scans these for the most-urgent finite deadline when deciding
        whether deadline-driven preemption should fire."""
        out: List[Request] = []
        for q in self._sched.queues.values():
            out.extend(q.pending)
        return out
