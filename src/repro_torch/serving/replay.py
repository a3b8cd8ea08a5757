"""Trace replay: arrival streams -> continuous-batching runtime -> the same
``Request`` / TTFT / TPOT records the reference emits (port of
``repro/serving/replay.py`` without fault plans, preemption requeues or
deadline shedding, which are not ported yet).

Clock model: a *virtual* clock starts at 0 and advances by the measured
wall time of every dispatch (prefill group / decode chunk); when the
runtime is idle it jumps to the next arrival or batching timer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.sampling import SamplingParams
from repro_torch.serverless.batching import Request
from repro_torch.serverless.simulator import SimResult
from repro_torch.serving import telemetry as tm
from repro_torch.serving.runtime import ContinuousRuntime, ServeRequest
from repro_torch.serving.slots import AdmissionScheduler, SlotState


@dataclasses.dataclass
class ReplayEvent:
    t: float
    kind: str        # admit | finish | abandon | abort | stall | reject
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
                 token_sink: Optional[Dict[int, List[int]]] = None,
                 sampling: Optional[Dict[int, SamplingParams]] = None
                 ) -> Tuple[SimResult, List[ReplayEvent]]:
    """Feed a ``serverless.traces.make_workload`` stream through the
    runtime.  ``fn_adapter`` maps fn_id -> adapter bank slot; ``prompts``
    maps req_id -> token array (default: synthesized from the trace
    lengths); ``token_sink`` collects every survivor's accepted tokens
    (prefill token first); ``sampling`` maps req_id -> SamplingParams
    (default greedy).  Oversized requests and out-of-range adapters are
    rejected gracefully.  Ends with ``runtime.check_invariants(requests)``.
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

    def finish(st: SlotState, t_done: float) -> None:
        st.req.done = t_done
        live.pop(st.sid, None)
        if tel is not None:
            tel.instant(tm.EVT_FINISH,
                        f"slot{st.sid}" if st.sid >= 0 else tm.TRACK_QUEUE,
                        t_done, req_id=st.req.req_id, tokens=st.produced)
        log("finish", st.req.req_id, st.sid, f"{st.produced} tokens")

    while ai < len(arrivals) or sched.pending or runtime.slots.num_active:
        while ai < len(arrivals) and arrivals[ai].arrival <= now + 1e-12:
            sched.push(arrivals[ai])
            ai += 1
        for r in sched.abandon_expired(now):
            runtime.stats["abandoned"] += 1
            if tel is not None:
                tel.instant(tm.EVT_ABANDON, tm.TRACK_QUEUE, now,
                            req_id=r.req_id, waited_s=now - r.arrival)
            log("abandon", r.req_id, detail=f"slo {r.slo_ttft}s lapsed")

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
            res = runtime.try_admit([serve_request(r) for r in batch])
            if res is None and len(batch) > 1:
                # group doesn't fit the remaining blocks — shrink to one
                sched.requeue_front(batch[1:])
                batch = batch[:1]
                res = runtime.try_admit([serve_request(batch[0])])
            if res is None:                  # blocks short: requeue
                sched.requeue_front(batch)
                if runtime.slots.num_active == 0 and runtime.pool.in_use == 0:
                    raise RuntimeError(
                        "KV pool too small for a single request — grow "
                        "num_blocks or shrink max_blocks_per_slot / "
                        "prompt lengths")
                break
            if res.rejected:
                rej = {id(r) for r in res.rejected}
                for r in res.rejected:
                    if tel is not None:
                        tel.instant(tm.EVT_REJECT, tm.TRACK_QUEUE, now,
                                    req_id=r.req_id, fn_id=r.fn_id)
                    log("reject", r.req_id,
                        detail=f"adapter for {r.fn_id} not in the bank")
                batch = [r for r in batch if id(r) not in rej]
                if not batch:
                    continue
            t_disp = now
            now += res.dt
            if tel is not None:
                tel.span("dispatch:prefill", tm.TRACK_HOST, t_disp, now,
                         requests=len(batch))
            for i, r in enumerate(batch):
                r.dispatch = max(t_disp, r.arrival)
                r.first_token = now
                r.breakdown["queue_wait"] = r.dispatch - r.arrival
                r.breakdown["prefill"] = res.dt
                token_times[r.req_id] = [now]
                if token_sink is not None:
                    token_sink[r.req_id] = [int(res.first_tokens[i])]
                shared = res.shared_blocks[i] if res.shared_blocks else 0
                if tel is not None:
                    track = (f"slot{res.slot_ids[i]}"
                             if res.slot_ids[i] >= 0 else tm.TRACK_QUEUE)
                    tel.span(tm.SPAN_QUEUED, tm.TRACK_QUEUE, r.arrival,
                             r.dispatch, req_id=r.req_id)
                    tel.span(tm.SPAN_PREFILL, track, r.dispatch, now,
                             req_id=r.req_id, prompt_len=r.prompt_len,
                             shared_blocks=shared,
                             **{tm.ARG_SAMPLING_MODE: mode_of(r.req_id)})
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
            # idle: jump to the next arrival / batching timer
            nxt = []
            if ai < len(arrivals):
                nxt.append(arrivals[ai].arrival)
            t = sched.next_timer(now)
            if t is not None:
                nxt.append(t)
            if not nxt:
                break
            now = max(now, min(nxt))
            continue
        chunk_t0 = now
        ddt = dres.dt
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
                    token_sink: Optional[Dict[int, List[int]]] = None
                    ) -> Tuple[SimResult, List[ReplayEvent]]:
    """Typed replay entry: a list of ``ServeRequest`` objects; req_ids are
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
            slo_ttft=float("inf"), slo_class=int(sr.slo_class)))
        prompts[i] = prompt
        if sr.sampling is not None:
            sampling[i] = sr.sampling
    return replay_trace(runtime, workload, fn_adapter,
                        prefill_group=prefill_group,
                        slo_abandon=slo_abandon,
                        collect_events=collect_events,
                        prompts=prompts, telemetry=telemetry,
                        token_sink=token_sink, sampling=sampling or None)
