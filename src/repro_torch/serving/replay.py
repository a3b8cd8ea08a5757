"""Trace replay: arrival streams -> continuous-batching runtime -> the same
``Request`` / TTFT / TPOT records the reference emits (port of
``repro/serving/replay.py``, with its robustness hooks: deadline shedding,
deadline-driven preemption, the preempted requests' requeue heap with
exponential backoff and a retry budget, and ``FaultPlan`` injection).

Clock model: a *virtual* clock starts at 0 and advances by the measured
wall time of every dispatch (prefill group / decode chunk); when the
runtime is idle it jumps to the next arrival, batching timer, retry
backoff expiry or fault-plan window edge.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sampling import SamplingParams
from repro_torch.serverless.batching import Request
from repro_torch.serverless.simulator import SimResult
from repro_torch.serving import telemetry as tm
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.runtime import ContinuousRuntime, ServeRequest
from repro_torch.serving.slots import AdmissionScheduler, SlotState


@dataclasses.dataclass
class ReplayEvent:
    t: float
    kind: str        # admit | finish | abandon | abort | stall | reject |
    #   preempt | resume
    req_id: int
    slot: int = -1
    detail: str = ""


def synth_prompts(workload: Sequence[Dict], vocab: int, seed: int = 0
                  ) -> Dict[int, np.ndarray]:
    """Deterministic stand-in prompts (the traces carry lengths, not text);
    the same draws as the reference's."""
    rng = np.random.default_rng(seed)
    return {w["req_id"]: rng.integers(0, vocab, size=w["prompt_len"],
                                      dtype=np.int32)
            for w in workload}


def replay_trace(runtime: ContinuousRuntime, workload: Sequence[Dict],
                 fn_adapter: Dict[str, int], *, seed: int = 0,
                 prefill_group: Optional[int] = None,
                 slo_abandon: bool = True,
                 collect_events: bool = False,
                 prompts: Optional[Dict[int, np.ndarray]] = None,
                 telemetry: Optional[tm.Telemetry] = None,
                 faults: Optional[FaultPlan] = None,
                 token_sink: Optional[Dict[int, List[int]]] = None,
                 sampling: Optional[Dict[int, SamplingParams]] = None
                 ) -> Tuple[SimResult, List[ReplayEvent]]:
    """Feed a ``serverless.traces.make_workload`` stream through the
    runtime.  ``fn_adapter`` maps fn_id -> adapter (registry name or bank
    slot); ``prompts`` maps req_id -> token array (default: synthesized
    from the trace lengths); ``token_sink`` collects every survivor's
    accepted tokens (prefill token first); ``sampling`` maps req_id ->
    SamplingParams (default greedy); ``telemetry`` attaches a span
    recorder (recording never changes replay results).  Oversized
    requests and unknown adapters are rejected gracefully.

    Robustness hooks, as the reference's:

    * Trace items may carry ``slo_class`` / ``deadline_ttft`` /
      ``deadline_e2e`` — finite deadlines turn on admission-time shedding
      (``rejected_deadline``) and, with ``robust.preemption`` enabled,
      deadline-driven preemption of lower-class slots.
    * Preempted requests (deadline-driven, or the all-stall victim under
      pool exhaustion) have their completed KV demoted to the cached LRU
      and re-enter the queue after exponential backoff
      (``robust.backoff_s * 2**(n-1)``); the resume recomputes only what
      the prefix cache no longer covers.  After ``robust.retry_budget``
      preemptions the request goes terminal ``abandoned``
      (``breakdown["abandoned_retries"]``).  A requeued request's recorded
      tokens are dropped: its greedy (or seeded) decode re-emits them.
    * ``faults`` attaches a deterministic ``FaultPlan`` (to
      ``runtime.faults`` for the replay, restored afterwards): pool
      squeezes open/close on the virtual clock, dispatch slowdowns scale
      measured dt (virtual clock only — tokens are untouched), artifact
      faults reach the adapter registry.  An EMPTY plan is a no-op.
    * Ends with ``runtime.check_invariants(requests)``: pool refcounts,
      adapter pins, and every request in exactly one terminal state.

    Returns (SimResult, events)."""
    scfg = runtime.scfg
    group = prefill_group or 2
    if telemetry is not None:
        runtime.telemetry = telemetry
    tel = runtime.telemetry
    timings = runtime.warmup()
    sched = AdmissionScheduler(group=group, slo_abandon=slo_abandon)
    t0 = timings["prefill_chunk_s"]
    for fn_id in fn_adapter:
        sched.register(fn_id, t0, 0.15 * t0 / max(group, 1))

    if prompts is None:
        prompts = synth_prompts(workload, runtime.cfg.vocab_size, seed)
    else:
        missing = [w["req_id"] for w in workload
                   if w["req_id"] not in prompts]
        if missing:
            raise ValueError(f"prompts missing req_id(s) {missing[:8]}"
                             + ("..." if len(missing) > 8 else ""))
        for w in workload:
            if len(prompts[w["req_id"]]) != w["prompt_len"]:
                raise ValueError(
                    f"req {w['req_id']}: prompt array length "
                    f"{len(prompts[w['req_id']])} != trace prompt_len "
                    f"{w['prompt_len']}")
    requests: List[Request] = [Request(**w) for w in workload]
    arrivals = sorted(requests, key=lambda r: r.arrival)

    events: List[ReplayEvent] = []
    token_times: Dict[int, List[float]] = {}
    live: Dict[int, Request] = {}            # sid -> request
    now, ai = 0.0, 0
    rcfg = scfg.robust
    prev_faults = runtime.faults
    if faults is not None:
        runtime.faults = faults      # artifact loaders consult this
    # preempted requests waiting out their backoff: (ready_t, seq, Request).
    # seq breaks ready-time ties deterministically (heapq would otherwise
    # compare Request objects)
    retryq: List[Tuple[float, int, Request]] = []
    retry_seq = 0

    def log(kind: str, req_id: int, slot: int = -1, detail: str = "") -> None:
        if collect_events:
            events.append(ReplayEvent(now, kind, req_id, slot, detail))

    def sp_of(req_id: int) -> Optional[SamplingParams]:
        return sampling.get(req_id) if sampling is not None else None

    def mode_of(req_id: int) -> str:
        sp = sp_of(req_id)
        return sp.mode() if sp is not None else "greedy"

    def serve_request(r: Request) -> ServeRequest:
        return ServeRequest(prompt=prompts[r.req_id],
                            adapter=fn_adapter[r.fn_id], arrival=r.arrival,
                            max_new_tokens=r.output_len, request=r,
                            sampling=sp_of(r.req_id))

    def requeue_preempted(st: SlotState, emit_evt: bool) -> None:
        """Preempted slot -> backoff heap (or terminal ``abandoned`` when
        the retry budget is spent).  The runtime already demoted the
        slot's completed KV to the cached LRU and released everything;
        here the REQUEST restarts: first_token/dispatch reset (the resume
        re-earns them), recorded tokens dropped (greedy decode re-emits
        them bitwise on resume)."""
        nonlocal retry_seq
        r = st.req
        live.pop(st.sid, None)
        n = int(r.breakdown.get("preempted", 0.0))
        if emit_evt and tel is not None:
            tel.instant(tm.EVT_PREEMPT, f"slot{st.sid}", now,
                        req_id=r.req_id, attempt=n)
        r.breakdown["preempt_t"] = now
        r.first_token = -1
        r.dispatch = -1.0
        token_times.pop(r.req_id, None)
        if token_sink is not None:
            token_sink.pop(r.req_id, None)
        if n > rcfg.retry_budget:
            r.breakdown["abandoned_retries"] = float(n)
            runtime.stats["abandoned"] += 1
            if tel is not None:
                tel.instant(tm.EVT_ABANDON, tm.TRACK_QUEUE, now,
                            req_id=r.req_id, retries=n)
            log("abandon", r.req_id, st.sid,
                f"retry budget {rcfg.retry_budget} exhausted "
                f"after {n} preemptions")
            return
        backoff = rcfg.backoff_s * (2.0 ** max(n - 1, 0))
        retry_seq += 1
        heapq.heappush(retryq, (now + backoff, retry_seq, r))
        runtime.stats["retries"] += 1
        log("preempt", r.req_id, st.sid,
            f"requeued (attempt {n}), backoff {backoff:.4f}s")

    def finish(st: SlotState, t_done: float) -> None:
        st.req.done = t_done
        live.pop(st.sid, None)
        held = sum(1 for b in st.blocks if b >= 0)
        if tel is not None:
            tel.instant(tm.EVT_FINISH,
                        f"slot{st.sid}" if st.sid >= 0 else tm.TRACK_QUEUE,
                        t_done, req_id=st.req.req_id, tokens=st.produced)
        log("finish", st.req.req_id, st.sid,
            f"{st.produced} tokens, {held} blocks released"
            + (f", {st.reclaimed} reclaimed mid-flight"
               if st.reclaimed else ""))

    while ai < len(arrivals) or sched.pending or runtime.slots.num_active \
            or retryq:
        if faults is not None:
            faults.advance(runtime, now)
        while ai < len(arrivals) and arrivals[ai].arrival <= now + 1e-12:
            sched.push(arrivals[ai])
            ai += 1
        while retryq and retryq[0][0] <= now + 1e-12:
            _, _, r = heapq.heappop(retryq)
            sched.push(r)            # backoff served: back through admission
        for r in sched.abandon_expired(now):
            runtime.stats["abandoned"] += 1
            if tel is not None:
                tel.instant(tm.EVT_ABANDON, tm.TRACK_QUEUE, now,
                            req_id=r.req_id, waited_s=now - r.arrival)
            log("abandon", r.req_id, detail=f"slo {r.slo_ttft}s lapsed")

        # deadline-driven preemption: when the most-urgent queued request
        # would provably miss its TTFT deadline waiting for a natural slot,
        # evict one strictly-lower-SLO-class victim (its KV demotes to the
        # cached LRU; it retries with backoff).  Gated on robust.preemption
        # — the runtime method re-checks every precondition.
        if rcfg.preemption and sched.pending \
                and not runtime.slots.free_slots():
            urgent, margin = None, float("inf")
            for r in sched.pending_requests():
                if r.deadline_ttft != float("inf"):
                    m = r.deadline_ttft - (now - r.arrival)
                    if m < margin:
                        urgent, margin = r, m
            if urgent is not None:
                sid = runtime.deadline_preemption_victim(urgent, now)
                if sid is not None:
                    st = runtime.preempt(sid, now=now)  # emits EVT_PREEMPT
                    requeue_preempted(st, emit_evt=False)

        # admission: fill-or-expire groups, deadline-margin priority; under
        # load wait for a FULL group of free slots before a prefill
        while True:
            free = len(runtime.slots.free_slots())
            if runtime.slots.num_active > 0 and free < group \
                    and sched.pending >= group:
                break
            batch = sched.pop_ready(now, min(free, group))
            if not batch:
                break
            fit = []
            for r in batch:
                if runtime.fits(r.prompt_len, max(r.output_len, 1)):
                    fit.append(r)
                else:
                    runtime.reject_too_long(r)
                    if tel is not None:
                        tel.instant(tm.EVT_REJECT, tm.TRACK_QUEUE, now,
                                    req_id=r.req_id,
                                    prompt_len=r.prompt_len)
                    log("reject", r.req_id,
                        detail=f"prompt {r.prompt_len} + output "
                               f"{r.output_len} exceeds slot KV capacity")
            batch = fit
            if not batch:
                continue
            res = runtime.try_admit([serve_request(r) for r in batch],
                                    now=now)
            if res is None and len(batch) > 1:
                # group doesn't fit the remaining blocks — shrink to one
                sched.requeue_front(batch[1:])
                batch = batch[:1]
                res = runtime.try_admit([serve_request(batch[0])], now=now)
            if res is None:                  # blocks short: requeue
                sched.requeue_front(batch)
                if runtime.slots.num_active == 0 and runtime.pool.in_use == 0:
                    raise RuntimeError(
                        "KV pool too small for a single request — grow "
                        "num_blocks or shrink max_blocks_per_slot / "
                        "prompt lengths")
                break
            if res.rejected:
                # admission-side rejections (unknown/unloaded adapter or a
                # provably-unmeetable deadline — fits() was pre-filtered
                # above): the surviving per-item result lists align with
                # the remaining batch order
                rej = {id(r) for r in res.rejected}
                for r in res.rejected:
                    why = ("deadline unmeetable"
                           if "rejected_deadline" in r.breakdown
                           else f"adapter for {r.fn_id} not loaded")
                    if tel is not None:
                        tel.instant(tm.EVT_REJECT, tm.TRACK_QUEUE, now,
                                    req_id=r.req_id, fn_id=r.fn_id)
                    log("reject", r.req_id, detail=why)
                batch = [r for r in batch if id(r) not in rej]
                if not batch:
                    continue
            t_disp = now
            pdt = (res.dt if faults is None
                   else faults.dispatch_dt("prefill", t_disp, res.dt))
            now += pdt
            if tel is not None:
                tel.span("dispatch:prefill", tm.TRACK_HOST, t_disp, now,
                         requests=len(batch))
            for i, r in enumerate(batch):
                r.dispatch = max(t_disp, r.arrival)
                r.first_token = now
                r.breakdown["queue_wait"] = r.dispatch - r.arrival
                r.breakdown["prefill"] = pdt
                token_times[r.req_id] = [now]
                if token_sink is not None:
                    token_sink[r.req_id] = [int(res.first_tokens[i])]
                shared = res.shared_blocks[i] if res.shared_blocks else 0
                resumed = "preempt_t" in r.breakdown
                if tel is not None:
                    track = (f"slot{res.slot_ids[i]}"
                             if res.slot_ids[i] >= 0 else tm.TRACK_QUEUE)
                    tel.span(tm.SPAN_QUEUED, tm.TRACK_QUEUE, r.arrival,
                             r.dispatch, req_id=r.req_id)
                    if resumed:
                        # the preempt -> re-admission arc: backoff + queue
                        # wait on the queue track, then a resume marker on
                        # the slot that picked the request back up
                        tel.span(tm.SPAN_REQUEUED, tm.TRACK_QUEUE,
                                 r.breakdown["preempt_t"], r.dispatch,
                                 req_id=r.req_id)
                        tel.instant(tm.EVT_RESUME, track, now,
                                    req_id=r.req_id, shared_blocks=shared)
                    tel.span(tm.SPAN_PREFILL, track, r.dispatch, now,
                             req_id=r.req_id, prompt_len=r.prompt_len,
                             shared_blocks=shared,
                             **{tm.ARG_SAMPLING_MODE: mode_of(r.req_id)})
                if resumed:
                    log("resume", r.req_id, res.slot_ids[i],
                        f"{shared} prefix blocks recovered from cache")
                log("admit", r.req_id, res.slot_ids[i],
                    f"adapter {fn_adapter[r.fn_id]}, prompt {r.prompt_len}"
                    + (f", {shared} prefix blocks shared" if shared else ""))
            for st in res.finished:          # output_len == 1 / instant EOS
                finish(st, now)
            for sid in res.slot_ids:
                if sid >= 0 and runtime.slots.states[sid] is not None:
                    live[sid] = runtime.slots.states[sid].req

        dres = runtime.decode()
        if dres is None:
            # idle: jump to the next arrival / batching timer / retry-
            # backoff expiry / fault-plan window edge (a squeeze must
            # open and CLOSE even while the runtime is idle)
            nxt = []
            if ai < len(arrivals):
                nxt.append(arrivals[ai].arrival)
            t = sched.next_timer(now)
            if t is not None:
                nxt.append(t)
            if retryq:
                nxt.append(retryq[0][0])
            if faults is not None:
                t = faults.next_event(now)
                if t is not None:
                    nxt.append(t)
            if not nxt:
                break
            now = max(now, min(nxt))
            continue
        chunk_t0 = now
        ddt = (dres.dt if faults is None
               else faults.dispatch_dt("decode", chunk_t0, dres.dt))
        now += ddt
        if tel is not None:
            tel.span("dispatch:decode", tm.TRACK_HOST, chunk_t0, now,
                     rows=len(dres.emitted))
        finishing = {st.sid for st in dres.finished}
        for sid, toks in dres.emitted.items():
            st = runtime.slots.states[sid]
            req = st.req if st is not None else live.get(sid)
            if req is None or not toks:
                continue
            if tel is not None:
                tel.span(tm.SPAN_DECODE, f"slot{sid}", chunk_t0, now,
                         req_id=req.req_id, tokens=len(toks),
                         **{tm.ARG_SAMPLING_MODE: mode_of(req.req_id)})
            if sid in finishing:
                # a clipped final chunk: the last token lands at chunk end
                times = [chunk_t0 + ddt * (i + 1) / len(toks)
                         for i in range(len(toks))]
            else:
                per_tok = ddt / max(scfg.decode_chunk, 1)
                times = [chunk_t0 + (i + 1) * per_tok
                         for i in range(len(toks))]
            token_times.setdefault(req.req_id, []).extend(times)
            if token_sink is not None:
                token_sink.setdefault(req.req_id, []).extend(
                    int(t) for t in toks)
        for sid in dres.stalled:
            st = runtime.slots.states[sid]
            if st is not None:
                st.req.breakdown["stalled_chunks"] = \
                    st.req.breakdown.get("stalled_chunks", 0.0) + 1.0
                if tel is not None:
                    tel.instant(tm.EVT_STALL, f"slot{sid}", now,
                                req_id=st.req.req_id)
                log("stall", st.req.req_id, sid, "pool exhausted")
        for st in dres.finished:
            tt = token_times.get(st.req.req_id, [now])
            finish(st, tt[-1])
        for st in dres.aborted:
            st.req.done = now
            live.pop(st.sid, None)
            if tel is not None:
                tel.instant(tm.EVT_ABORT, f"slot{st.sid}", now,
                            req_id=st.req.req_id)
            log("abort", st.req.req_id, st.sid, "evicted: pool exhausted")
        for st in dres.preempted:
            # force-evict under exhaustion with robust.preemption on:
            # instead of a terminal abort the victim's KV was demoted to
            # the cached LRU and the request retries with backoff
            requeue_preempted(st, emit_evt=True)

    if faults is not None:
        faults.finish(runtime)       # windows past trace end: release all
        runtime.faults = prev_faults
    for r in requests:
        if r.first_token >= 0 and r.done >= 0:
            r.breakdown.setdefault(
                "decode", max(r.done - r.first_token, 0.0))
    m = runtime.metrics
    for r in requests:
        if r.first_token < 0:
            continue
        m.histogram("ttft_s", "first_token - arrival").observe(
            r.first_token - r.arrival)
        m.histogram("queue_wait_s", "dispatch - arrival").observe(
            r.dispatch - r.arrival)
        if r.done >= 0:
            m.histogram("e2e_s", "done - arrival").observe(
                r.done - r.arrival)
            if r.output_len > 1:
                m.histogram(
                    "tpot_s", "(done - first_token) / (output_len - 1)"
                ).observe((r.done - r.first_token)
                          / max(r.output_len - 1, 1))
    runtime.check_invariants(requests)
    return SimResult("continuous-real", requests, 0.0, 0.0), events


def replay_requests(runtime: ContinuousRuntime,
                    requests: Sequence[ServeRequest], *,
                    prefill_group: Optional[int] = None,
                    slo_abandon: bool = True,
                    collect_events: bool = False,
                    telemetry: Optional[tm.Telemetry] = None,
                    faults: Optional[FaultPlan] = None,
                    token_sink: Optional[Dict[int, List[int]]] = None
                    ) -> Tuple[SimResult, List[ReplayEvent]]:
    """Typed replay entry: a list of ``ServeRequest`` objects (each with
    its own prompt, adapter, SLO class and deadlines); req_ids are
    positional."""
    workload: List[Dict] = []
    prompts: Dict[int, np.ndarray] = {}
    fn_adapter: Dict[str, object] = {}
    sampling: Dict[int, SamplingParams] = {}
    for i, sr in enumerate(requests):
        prompt = np.asarray(sr.prompt)
        fn = str(sr.adapter)
        fn_adapter[fn] = 0 if sr.adapter is None else sr.adapter
        workload.append(dict(
            req_id=i, fn_id=fn, arrival=float(sr.arrival),
            prompt_len=len(prompt),
            output_len=max(int(sr.max_new_tokens), 1),
            slo_ttft=float("inf"), slo_class=int(sr.slo_class),
            deadline_ttft=float(sr.deadline_ttft),
            deadline_e2e=float(sr.deadline_e2e)))
        prompts[i] = prompt
        if sr.sampling is not None:
            sampling[i] = sr.sampling
    return replay_trace(runtime, workload, fn_adapter,
                        prefill_group=prefill_group,
                        slo_abandon=slo_abandon,
                        collect_events=collect_events,
                        prompts=prompts, telemetry=telemetry,
                        faults=faults, token_sink=token_sink,
                        sampling=sampling or None)
