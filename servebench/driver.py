"""The window's driver: an open loop on the wall clock over the program's
public serving API.

Requests are released into ``AdmissionScheduler`` when they are due;
groups it hands out go through ``ContinuousRuntime.try_admit`` (the prefill
dispatches) and every pass ends in one ``ContinuousRuntime.decode`` chunk
while a slot is bound.  The order of operations is that of the program's
``serving/replay.py::replay_trace`` (release, admission with its
full-group rule and its shrink-to-one retry, then one decode chunk), with
one difference: the clock is ``time.perf_counter``, so idle time passes
(the loop sleeps until the next request is due or a batching timer
expires) and host work between dispatches counts.  Every latency is timed
from the time the request was due.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serverless.batching import Request
from repro_torch.serving.runtime import ServeRequest
from repro_torch.serving.slots import AdmissionScheduler
from servebench.traffic import Req


@dataclasses.dataclass
class Record:
    req: Req
    bound: float = math.nan          # try_admit called for its group
    first: float = math.nan          # first token on the host
    done: float = math.nan
    times: List[Tuple[float, int]] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    failed: str = ""


@dataclasses.dataclass
class Span:
    kind: str                        # prefill | decode | sleep
    t0: float
    t1: float
    info: Dict[str, Any] = dataclasses.field(default_factory=dict)


class DispatchTap:
    """Stands in front of one of the runtime's captured dispatches and
    keeps a copy of the host arrays each call is given (the traced run
    counts each kernel launch's work from them); everything else passes
    through."""

    def __init__(self, inner, keep: Sequence[int], sink: List):
        self._inner = inner
        self._keep = tuple(keep)
        self._sink = sink

    def __call__(self, *args):
        self._sink.append(tuple(np.array(args[i]) for i in self._keep))
        return self._inner(*args)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class OpenLoop:
    def __init__(self, rt, reqs: Sequence[Req], fn_names: Sequence[str], *,
                 group: int, slo_ttft: float, origin: float,
                 clock: Callable[[], float] = time.perf_counter,
                 span: Optional[Callable[[str], Any]] = None):
        """``origin``: the clock reading of the window's start; the
        requests' due times are seconds from it.  ``span(name)`` opens a
        range around each call into the runtime (the profiler's, in a
        traced run)."""
        self.rt = rt
        self.reqs = sorted(reqs, key=lambda r: (r.due, r.rid))
        self.fn_names = list(fn_names)
        self.group = group
        self.slo_ttft = slo_ttft
        self.origin = origin
        self.clock = clock
        self.span = span or (lambda name: contextlib.nullcontext())
        self.sched = AdmissionScheduler(group=group, slo_abandon=False)
        t0 = rt.metrics.gauges["warmup_prefill_chunk_s"].last
        for name in self.fn_names:
            self.sched.register(name, t0, 0.15 * t0 / max(group, 1))
        self.records: Dict[int, Record] = {r.rid: Record(r)
                                           for r in self.reqs}
        self.slot_rid: Dict[int, int] = {}
        self.spans: List[Span] = []
        self.pending: List[Tuple[float, float]] = []   # work waiting
        self._pend_since: Optional[float] = None
        self.taps: List = []           # dispatch inputs, in call order
        self.stalls = 0
        self._next = 0

    # ------------------------------------------------------------ clock
    def now(self) -> float:
        return self.clock() - self.origin

    def tap_dispatches(self) -> None:
        """Keep each dispatch's inputs: decode (pos, table, adapters),
        prefill (start, table, adapters).  A runtime without these
        dispatches is left alone (the readers then find nothing)."""
        rt = self.rt
        if hasattr(rt, "_decode") and hasattr(rt, "_prefill"):
            rt._decode = DispatchTap(rt._decode, (1, 2, 3), self.taps)
            rt._prefill = DispatchTap(rt._prefill, (1, 5, 3), self.taps)

    # ------------------------------------------------------------ loop
    def _release(self, now: float) -> None:
        while self._next < len(self.reqs) and self.reqs[self._next].due \
                <= now:
            r = self.reqs[self._next]
            self.sched.push(Request(
                req_id=r.rid, fn_id=self.fn_names[r.fn], arrival=r.due,
                prompt_len=len(r.prompt), output_len=r.output_len,
                slo_ttft=self.slo_ttft))
            self._next += 1

    def _busy(self) -> bool:
        return self.rt.slots.num_active > 0 or self.sched.pending > 0

    def _mark_pending(self, now: float) -> None:
        busy = self._busy()
        if busy and self._pend_since is None:
            self._pend_since = now
        elif not busy and self._pend_since is not None:
            self.pending.append((self._pend_since, now))
            self._pend_since = None

    def _serve_request(self, r: Request) -> ServeRequest:
        q = self.records[r.req_id].req
        return ServeRequest(prompt=q.prompt, adapter=r.fn_id,
                            arrival=r.arrival, max_new_tokens=q.output_len,
                            request=r)

    def _admit(self) -> None:
        rt, sched, group = self.rt, self.sched, self.group
        while True:
            free = len(rt.slots.free_slots())
            if rt.slots.num_active > 0 and free < group \
                    and sched.pending >= group:
                break
            now = self.now()
            batch = sched.pop_ready(now, min(free, group))
            if not batch:
                break
            fit = [r for r in batch
                   if rt.fits(r.prompt_len, max(r.output_len, 1))]
            for r in batch:
                if r not in fit:
                    rt.reject_too_long(r)
                    self.records[r.req_id].failed = "too long"
            batch = fit
            if not batch:
                continue
            t0 = self.now()
            n_taps = len(self.taps)
            with self.span("servebench.prefill"):
                res = rt.try_admit([self._serve_request(r) for r in batch],
                                   now=t0)
                if res is None and len(batch) > 1:
                    sched.requeue_front(batch[1:])
                    batch = batch[:1]
                    res = rt.try_admit([self._serve_request(batch[0])],
                                       now=t0)
            t1 = self.now()
            if res is None:
                sched.requeue_front(batch)
                if rt.slots.num_active == 0 and rt.pool.in_use == 0:
                    raise RuntimeError("KV pool too small for one request")
                break
            for r in res.rejected:
                self.records[r.req_id].failed = "rejected"
            rej = {id(r) for r in res.rejected}
            batch = [r for r in batch if id(r) not in rej]
            self.spans.append(Span("prefill", t0, t1, {
                "taps": (n_taps, len(self.taps)),
                "admitted": [(r.req_id, len(self.records[r.req_id]
                                            .req.prompt), s)
                             for r, s in zip(batch, res.shared_blocks)]}))
            for i, r in enumerate(batch):
                rec = self.records[r.req_id]
                rec.bound, rec.first = t0, t1
                rec.times.append((t1, 1))
                rec.tokens.append(int(res.first_tokens[i]))
                sid = res.slot_ids[i]
                if sid >= 0:
                    self.slot_rid[sid] = r.req_id
                else:
                    rec.done = t1

    def _decode(self) -> None:
        rt = self.rt
        pos = rt.slots.pos.copy()
        t0 = self.now()
        n_taps = len(self.taps)
        with self.span("servebench.decode"):
            dres = rt.decode()
        t1 = self.now()
        if dres is None:
            return
        self.spans.append(Span("decode", t0, t1, {
            "taps": (n_taps, len(self.taps)),
            "emitted": {sid: (int(pos[sid]), len(toks))
                        for sid, toks in dres.emitted.items()}}))
        for sid, toks in dres.emitted.items():
            rec = self.records[self.slot_rid[sid]]
            if toks:
                rec.times.append((t1, len(toks)))
                rec.tokens.extend(int(t) for t in toks)
        self.stalls += len(dres.stalled)
        for st in dres.finished:
            self.records[self.slot_rid.pop(st.sid)].done = t1
        for st in list(dres.aborted) + list(dres.preempted):
            self.records[self.slot_rid.pop(st.sid)].failed = "evicted"

    def run_until(self, t_stop: float) -> None:
        """Serve until the clock reads ``t_stop`` (seconds from the
        window's start).  A dispatch under way at that time runs to its
        end."""
        while True:
            now = self.now()
            if now >= t_stop:
                self._mark_pending(now)
                return
            self._release(now)
            self._mark_pending(now)
            self._admit()
            if self.rt.slots.num_active:
                self._decode()
                continue
            now = self.now()
            wake = [t_stop]
            if self._next < len(self.reqs):
                wake.append(self.reqs[self._next].due)
            t = self.sched.next_timer(now)
            if t is not None:
                wake.append(t)
            target = min(wake)
            if target > now:
                self._mark_pending(now)
                with self.span("servebench.sleep"):
                    time.sleep(target - now)
                self.spans.append(Span("sleep", now, self.now()))

    def close_pending(self, t: float) -> None:
        if self._pend_since is not None:
            self.pending.append((self._pend_since, t))
            self._pend_since = None
