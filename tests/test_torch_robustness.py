"""Overload robustness of the port (``repro_torch.serving``: deadline
shedding, abort, preemption with demote-to-cached resume, the replay's
requeue heap, ``FaultPlan`` injection and the terminal-state audit) held
against the reference's, case for case with ``tests/test_robustness.py``.

Both runtimes run the SMOKE Llama config in float32 on the CPU, over the
same weights (the reference's, LoRA B drawn nonzero, carried across by
``checkpoint/bridge.py``), under deterministic fake clocks: the port takes
the reference's timer readings in the same order, so the two replays take
the same decisions.  Each case requires equal greedy tokens, counters,
terminal states, request records and ``ReplayEvent`` sequences.  Sampled
tokens cannot match across frameworks (the port keys its draws with its
own Philox), so the sampled preempt/resume case holds the port's resumed
stream against the port's own uninterrupted one and its counters against
the reference's.

The reference's checkpoint-retry case runs against the port's
``checkpoint/store.py`` in ``tests/test_torch_checkpoint.py``
(``test_checkpoint_load_retries_through_fault_hook``).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax
import numpy as np
import pytest

import repro.serving as ref
import repro_torch.serving as port
from conftest import FakeTimer, build_model, make_runtime
from repro.checkpoint.store import _flatten, _unflatten
from repro.core.lora import partition_lora as jax_partition_lora
from repro.serverless.batching import Request as RefRequest
from repro.serverless.traces import TraceSpec, make_workload
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.core.lora import partition_lora, take_adapter
from repro_torch.core.sampling import SamplingParams as PortSampling
from repro_torch.serverless.batching import Request as PortRequest

CFG_T = get_smoke("llama2_7b").with_(dtype="float32")
BS = 8
COUNTERS = ("rejected_deadline", "aborted", "abandoned", "preemptions",
            "retries", "resume_prefix_hits", "demoted_blocks",
            "injected_pool_squeezes", "stall_steps", "recomputed_tokens",
            "shared_block_maps", "prefill_chunks", "decode_chunks",
            "artifact_retries")


@pytest.fixture(scope="module")
def models():
    """Reference SMOKE params (3-adapter bank, LoRA B nonzero) in both
    packages."""
    cfg_j, params = build_model("llama2_7b")
    flat = _flatten(params)
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if "/lora/" in k and k.endswith("/b"):
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
    return cfg_j, _unflatten(flat), params_from_flat(flat, CFG_T,
                                                     device="cpu")


def _port_runtime(models, *, num_blocks=32, **robust):
    """The port's runtime: 4 slots over ``num_blocks`` 8-token blocks (the
    shape of conftest's ``make_runtime``), on a fake clock."""
    return port.ContinuousRuntime(
        CFG_T, models[2], port.ServingConfig(
            num_slots=4, block_size=BS, num_blocks=num_blocks,
            max_blocks_per_slot=6, prefill_chunk=16, decode_chunk=4,
            robust=port.RobustConfig(**robust)),
        device="cpu", timer=FakeTimer())


def _runtimes(models, *, num_blocks=32, **robust):
    """(reference runtime, port runtime) of the same shape and the same
    ``RobustConfig`` fields, each on its own fake clock."""
    cfg_j, pj, _ = models
    rt_j = make_runtime(cfg_j, pj, block_size=BS, num_blocks=num_blocks,
                        robust=ref.RobustConfig(**robust), timer=FakeTimer())
    return rt_j, _port_runtime(models, num_blocks=num_blocks, **robust)


def _workload(duration=3.0, seed=5, output_len=8, rate=1.5, fns=3):
    specs = [TraceSpec(f"fn{i}", "bursty", rate, duration, prompt_len=12,
                       output_len=output_len, slo_ttft=1e9)
             for i in range(fns)]
    return make_workload(specs, seed=seed), {f"fn{i}": i for i in range(fns)}


def _replay(pkg, rt, wl, fa, **kw):
    """One replay with events and tokens collected: (records, tokens,
    events)."""
    sink = {}
    res, events = pkg.replay_trace(rt, [dict(w) for w in wl], fa,
                                   collect_events=True, token_sink=sink,
                                   **kw)
    return ([dataclasses.asdict(r) for r in res.requests], sink,
            [dataclasses.asdict(e) for e in events])


def _assert_same_counters(rt_j, rt_t):
    got = {k: rt_t.stats[k] for k in COUNTERS}
    want = {k: rt_j.stats[k] for k in COUNTERS}
    assert got == want


# ------------------------------------------------------ retry primitive
def test_retry_with_backoff_matches_reference():
    def run(retry, err):
        calls, slept = {"n": 0}, []

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise err("transient")
            return "ok"

        out = retry(flaky, retries=2, backoff_s=0.1, sleep=slept.append)
        with pytest.raises(err):
            retry(lambda: (_ for _ in ()).throw(err("permanent")),
                  retries=2, sleep=slept.append)
        with pytest.raises(ValueError):
            retry(flaky, retries=-1)
        return out, calls["n"], slept

    got = run(port.retry_with_backoff, port.ArtifactLoadError)
    assert got == run(ref.retry_with_backoff, ref.ArtifactLoadError)
    assert got == ("ok", 3, [0.1, 0.2])


# ----------------------------------------------------- terminal taxonomy
@pytest.mark.parametrize("flags,times", [
    ({}, None), ({}, (1.0, 2.0)), ({}, (1.0, -1.0)),
    ({"rejected_deadline": 1.0}, None),
    ({"rejected_unknown_adapter": 1.0}, None),
    ({"abandoned": 3.0}, None), ({"abandoned_retries": 4.0}, (1.0, -1.0)),
    ({"aborted_oom": 1.0}, (1.0, 2.0)), ({"aborted": 1.0}, (1.0, 2.0)),
    ({"preempted": 1.0}, None),
    ({"aborted": 1.0, "rejected_deadline": 1.0}, None),
    ({"abandoned": 1.0, "aborted_oom": 1.0}, (1.0, 2.0)),
])
def test_terminal_state_classification(flags, times):
    def classify(cls, fn):
        r = cls(req_id=0, fn_id="f", arrival=0.0, prompt_len=4,
                output_len=4, slo_ttft=1.0)
        r.breakdown.update(flags)
        if times is not None:
            r.first_token, r.done = times
        try:
            return fn(r)
        except ValueError:
            return "ValueError"

    got = classify(PortRequest, port.terminal_state)
    assert got == classify(RefRequest, ref.terminal_state)
    if len(flags) == 2:
        assert got == "ValueError"


# --------------------------------------------- empty plan is a no-op
def test_empty_fault_plan_bitwise_identical(models):
    wl, fa = _workload()
    rt_j, rt_t = _runtimes(models)
    want = _replay(ref, rt_j, wl, fa, seed=3, slo_abandon=False)
    got = _replay(port, rt_t, wl, fa, seed=3, slo_abandon=False)
    assert got == want                              # records, tokens, events
    plan = port.FaultPlan()
    assert plan.empty()
    rt_t = _port_runtime(models)
    assert _replay(port, rt_t, wl, fa, seed=3, slo_abandon=False,
                   faults=plan) == got
    assert plan.report() == {"artifact_failures": 0, "pool_squeezes": 0,
                             "slowed_dispatches": 0}


# ------------------------------------------------------- deadline shedding
def test_deadline_shedding_provable_misses_only(models):
    wl, fa = _workload(seed=9)
    doomed = {w["req_id"] for w in wl if w["req_id"] % 2 == 0}
    for w in wl:
        if w["req_id"] in doomed:
            w["deadline_ttft"] = 1e-9
    rt_j, rt_t = _runtimes(models)
    want = _replay(ref, rt_j, wl, fa, slo_abandon=False)
    got = _replay(port, rt_t, wl, fa, slo_abandon=False)
    assert got == want
    shed = {r["req_id"] for r in got[0]
            if "rejected_deadline" in r["breakdown"]}
    assert shed == doomed
    _assert_same_counters(rt_j, rt_t)
    assert rt_t.stats["rejected_deadline"] == len(doomed)
    # the floors the shedding read: minimum observed dispatch times, equal
    # under the shared clock sequence
    for L, out, cov in ((12, 8, 0), (40, 1, 16), (5, 30, 0)):
        assert rt_t.deadline_floors(L, out, cov) == \
            rt_j.deadline_floors(L, out, cov)
    assert rt_t._prefill_rounds(40, 16) == rt_j._prefill_rounds(40, 16)


# --------------------------------------------------------- abort account
def test_abort_releases_everything(models):
    rt_j, rt_t = _runtimes(models)
    out = []
    for pkg, rt, req_cls in ((ref, rt_j, RefRequest),
                             (port, rt_t, PortRequest)):
        reg = pkg.AdapterRegistry(rt, names=["a0", "a1", "a2"])
        rt.warmup()
        prompt = np.arange(12, dtype=np.int32) % 512
        req = req_cls(req_id=7, fn_id="a1", arrival=0.0, prompt_len=12,
                      output_len=16, slo_ttft=1e9)
        res = rt.try_admit([pkg.ServeRequest(prompt=prompt, adapter="a1",
                                             max_new_tokens=16,
                                             request=req)])
        assert res is not None and res.slot_ids[0] >= 0
        first = list(res.first_tokens) + rt.decode().emitted[
            res.slot_ids[0]]
        assert not rt.abort(999)                    # unknown id: no-op
        assert rt.abort(7)
        report = rt.check_invariants([req])
        out.append((first, report, reg.pin_counts(),
                    {k: rt.stats[k] for k in COUNTERS},
                    sorted(req.breakdown), req.done,
                    rt.slots.num_active))
    assert out[1] == out[0]
    report = out[1][1]
    assert report["problems"] == [] and report["terminal"]["aborted"] == 1
    assert report["pool"]["live"] == 0              # demoted or freed
    assert report["pool"]["cached"] > 0             # completed KV parked
    assert out[1][2] == {}                          # pin released
    assert out[1][3]["aborted"] == 1 and out[1][3]["demoted_blocks"] > 0
    # the released slot's mirrors are reset before any later dispatch
    assert (rt_t.slots.block_tbl == -1).all() and not rt_t.slots.pos.any()


# --------------------------------------- preempt + cheap resume
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_preempt_resume_equal_tokens_and_strictly_cheaper(models, sampled):
    """Preempt after two chunks, resume through the prefix cache: the
    resumed stream equals the uninterrupted one (greedy: also the
    reference's tokens; sampled: the RNG counter is tokens-produced, so
    the resumed request replays the same keys), and the resume recomputes
    strictly fewer prompt tokens than a cold admission."""
    prompt = (np.arange(23, dtype=np.int32) * 5 + 1) % 512
    out = 12

    def admit(pkg, rt, req):
        sp = None
        if sampled:
            sp = (PortSampling if pkg is port else ref.SamplingParams)(
                temperature=0.9, top_k=20, seed=42)
        return rt.try_admit([pkg.ServeRequest(prompt=prompt, adapter=1,
                                              max_new_tokens=out,
                                              request=req, sampling=sp)],
                            now=0.0)

    def drain(rt, res):
        toks = list(res.first_tokens)
        sid = res.slot_ids[0]
        while rt.slots.states[sid] is not None:
            toks.extend(rt.decode().emitted.get(sid, []))
        return toks

    def preempted_run(pkg, rt, req_cls):
        rt.warmup()
        req = req_cls(req_id=0, fn_id="f", arrival=0.0,
                      prompt_len=len(prompt), output_len=out, slo_ttft=1e9)
        res = admit(pkg, rt, req)
        sid = res.slot_ids[0]
        rt.decode()
        rt.decode()
        produced = rt.slots.states[sid].produced
        assert rt.slots.rng_counter[sid] == produced
        st = rt.preempt(sid, now=1.0)
        assert st.req is req and st.produced == produced
        assert rt.slots.rng_counter[sid] == 0       # mirror reset
        assert rt.slots.num_active == 0 and rt.pool.in_use == 0
        cached = rt.pool.num_cached
        res2 = admit(pkg, rt, req)
        sid2 = res2.slot_ids[0]
        assert rt.slots.rng_counter[sid2] == rt.slots.states[sid2].produced
        toks = drain(rt, res2)
        rt.check_invariants()
        return (toks, cached, res2.shared_blocks,
                {k: rt.stats[k] for k in COUNTERS},
                dict(req.breakdown))

    rt_j, rt_t = _runtimes(models, preemption=True)
    want = preempted_run(ref, rt_j, RefRequest)
    got = preempted_run(port, rt_t, PortRequest)
    assert got[1:] == want[1:]          # pool, cover, counters, breakdown
    toks, cached, shared, stats, breakdown = got
    assert cached > 0 and shared[0] > 0
    assert stats["preemptions"] == 1 and stats["resume_prefix_hits"] == 1
    assert stats["demoted_blocks"] > 0
    assert 0 < breakdown["resumed_covered_tokens"]
    assert breakdown["resume_recomputed_tokens"] < len(prompt)
    # the uninterrupted oracle on the port
    rt_o = _port_runtime(models, preemption=True)
    rt_o.warmup()
    oracle = drain(rt_o, admit(port, rt_o, PortRequest(
        req_id=0, fn_id="f", arrival=0.0, prompt_len=len(prompt),
        output_len=out, slo_ttft=1e9)))
    assert toks == oracle and len(toks) == out
    if sampled:
        assert len(set(toks)) > 1, "sampled stream degenerate"
    else:
        assert toks == want[0]


def test_preempt_unbound_slot_raises(models):
    rt_t = _port_runtime(models, preemption=True)
    with pytest.raises(KeyError):
        rt_t.preempt(0)


# ------------------------------------- force-evict: one victim, bitwise
def test_all_stall_force_evict_single_victim_bitwise(models):
    wl, fa = _workload(duration=2.0, seed=2, output_len=16, rate=2.0, fns=1)
    rt_j, rt_t = _runtimes(models, num_blocks=8)
    want = _replay(ref, rt_j, wl, fa, slo_abandon=False)
    got = _replay(port, rt_t, wl, fa, slo_abandon=False)
    assert got == want
    _assert_same_counters(rt_j, rt_t)
    evicted = [r for r in got[0] if "aborted_oom" in r["breakdown"]]
    assert evicted and rt_t.stats["aborted"] == len(evicted)
    assert rt_t.stats["demoted_blocks"] > 0
    rt_a = _port_runtime(models)                    # oracle: nobody dies
    _, ample, _ = _replay(port, rt_a, wl, fa, slo_abandon=False)
    survivors = [r["req_id"] for r in got[0]
                 if r["first_token"] >= 0 and r["done"] >= 0
                 and "aborted_oom" not in r["breakdown"]]
    assert survivors
    for rid in survivors:
        assert got[1][rid] == ample[rid]
    assert rt_t.pool.in_use == 0 and rt_t.slots.num_active == 0


# ------------------------------- preemption under overload, retry budget
def test_preemption_replay_conserves_and_retries(models):
    wl, fa = _workload(duration=2.0, seed=2, output_len=16, rate=2.0, fns=1)
    robust = dict(preemption=True, retry_budget=2, backoff_s=0.01)
    rt_j, rt_t = _runtimes(models, num_blocks=8, **robust)
    tel = port.Telemetry()
    want = _replay(ref, rt_j, wl, fa, slo_abandon=False)
    got = _replay(port, rt_t, wl, fa, slo_abandon=False, telemetry=tel)
    assert got == want
    _assert_same_counters(rt_j, rt_t)
    assert rt_t.stats["preemptions"] > 0 and rt_t.stats["retries"] > 0
    states = {r["req_id"]: port.terminal_state(PortRequest(**r))
              for r in got[0]}
    assert set(states.values()) <= {"finished", "abandoned"}
    kinds = {e["kind"] for e in got[2]}
    assert {"preempt", "resume"} <= kinds
    assert not any("aborted_oom" in r["breakdown"] for r in got[0])
    retried = [r for r in got[0] if r["breakdown"].get("preempted")]
    assert retried
    for r in retried:
        if "abandoned_retries" in r["breakdown"]:
            assert r["breakdown"]["preempted"] > robust["retry_budget"]
    # the requeue arc is on the telemetry: a preempt instant per
    # preemption, a requeued span and a resume instant per re-admission
    names = [i.name for i in tel.instants]
    assert names.count("preempt") == rt_t.stats["preemptions"]
    assert sum(s.name == "requeued" for s in tel.spans) == \
        names.count("resume") > 0


# ---------------------------------- deadline-driven preemption in replay
@pytest.mark.parametrize("deadline", [4e-4, 8e-4])
def test_deadline_driven_preemption_matches_reference(models, deadline):
    """Four class-0 requests fill every slot; two class-1 requests with a
    finite TTFT deadline arrive behind them.  Waiting for a natural slot
    release provably misses the deadline, so the replay preempts the
    class-0 slot closest to completion (``deadline_preemption_victim``,
    ``preempt(sid, now=)``), requeues it with backoff, and it resumes
    through the prefix cache; the class-1 requests are admitted or shed
    as the reference's are."""
    wl = [dict(req_id=i, fn_id="bulk", arrival=0.0, prompt_len=12,
               output_len=32, slo_ttft=1e9) for i in range(4)]
    wl += [dict(req_id=4 + i, fn_id="premium", arrival=3e-4 + 1e-4 * i,
                prompt_len=12, output_len=8, slo_ttft=1e9, slo_class=1,
                deadline_ttft=deadline) for i in range(2)]
    fa = {"bulk": 0, "premium": 1}
    robust = dict(preemption=True, backoff_s=0.01)
    rt_j, rt_t = _runtimes(models, **robust)
    want = _replay(ref, rt_j, wl, fa, slo_abandon=False)
    got = _replay(port, rt_t, wl, fa, slo_abandon=False)
    assert got == want
    _assert_same_counters(rt_j, rt_t)
    assert rt_t.stats["preemptions"] == 1 and rt_t.stats["retries"] == 1
    assert rt_t.stats["resume_prefix_hits"] == 1
    assert [(e["kind"], e["req_id"]) for e in got[2]
            if e["kind"] in ("preempt", "resume")] == \
        [("preempt", 0), ("resume", 0)]
    assert {r["req_id"] for r in got[0]
            if "rejected_deadline" in r["breakdown"]} <= {4, 5}


# ----------------------------------------------- fault plan: pool + time
def test_pool_squeeze_and_slowdown_inject_deterministically(models):
    wl, fa = _workload(duration=2.0, seed=4)

    def plan(pkg):
        return pkg.FaultPlan(
            pool_squeezes=[pkg.PoolSqueeze(t0=0.0, t1=1.0, blocks=6)],
            slowdowns=[pkg.DispatchSlowdown(t0=0.0, t1=1e9, factor=4.0)])

    rt_j, rt_t = _runtimes(models)
    plan_j, plan_t = plan(ref), plan(port)
    want = _replay(ref, rt_j, wl, fa, slo_abandon=False, faults=plan_j)
    got = _replay(port, rt_t, wl, fa, slo_abandon=False, faults=plan_t)
    assert got == want
    _assert_same_counters(rt_j, rt_t)
    rep = plan_t.report()
    assert rep == plan_j.report()
    assert rep["pool_squeezes"] == 1 and rep["slowed_dispatches"] > 0
    assert rt_t.stats["injected_pool_squeezes"] == 1
    assert rt_t.pool.in_use == 0 and rt_t.faults is None
    # neither fault touches device results: tokens equal a fault-free run
    rt_b = _port_runtime(models)
    assert _replay(port, rt_b, wl, fa, slo_abandon=False)[1] == got[1]


# --------------------------------------------- artifact faults + retries
def test_adapter_load_retries_then_rolls_back(models):
    rt_j, rt_t = _runtimes(models)
    _, bank_j = jax_partition_lora(rt_j.params)
    tree_j = jax.tree_util.tree_map(
        lambda x: None if x is None else x[..., 0, :, :], bank_j,
        is_leaf=lambda x: x is None)
    tree_t = take_adapter(partition_lora(rt_t.params)[1], 0)
    out = []
    for pkg, rt, tree in ((ref, rt_j, tree_j), (port, rt_t, tree_t)):
        reg = pkg.AdapterRegistry(rt, names=["a0"])
        rt.faults = pkg.FaultPlan(artifact_faults=[
            pkg.ArtifactFault("adapter", name="flaky", fails=2)])
        reg.load("flaky", tree)                     # 2 fails, 2 retries
        step = [rt.stats["artifact_retries"], sorted(reg.names())]
        rt.faults = pkg.FaultPlan(artifact_faults=[
            pkg.ArtifactFault("adapter", name="cursed", fails=99)])
        with pytest.raises(pkg.ArtifactLoadError):
            reg.load("cursed", tree)
        step += [sorted(reg.names()), rt.faults.report()]
        rt.faults = None
        reg.load("recovered", tree)                 # freed slot reusable
        step += [sorted(reg.names()), rt.stats["artifact_retries"],
                 reg.pin_counts()]
        out.append(step)
    assert out[1] == out[0]
    assert out[1][0] == 2 and "flaky" in out[1][1]
    assert "cursed" not in out[1][2] and "recovered" in out[1][4]


# ----------------------------------------------------- invariant auditor
def test_check_invariants_detects_pin_leak(models):
    rt_j, rt_t = _runtimes(models)
    out = []
    for pkg, rt in ((ref, rt_j), (port, rt_t)):
        reg = pkg.AdapterRegistry(rt, names=["a0", "a1", "a2"])
        rt.warmup()
        prompt = np.arange(12, dtype=np.int32) % 512
        res = rt.try_admit([pkg.ServeRequest(prompt=prompt, adapter="a2",
                                             max_new_tokens=8)])
        assert res is not None
        clean = rt.check_invariants()["problems"]
        reg.pin(0)                                  # leak a pin on purpose
        report = rt.check_invariants(raise_on_error=False)
        with pytest.raises(AssertionError):
            rt.check_invariants()
        reg.unpin(0)
        while rt.slots.num_active:
            rt.decode()
        out.append((clean, report["problems"],
                    rt.check_invariants()["problems"]))
    assert out[1] == out[0]
    assert out[1][0] == [] and any("pin" in p for p in out[1][1])
    assert out[1][2] == []
