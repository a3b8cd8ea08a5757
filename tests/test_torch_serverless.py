"""The port's serverless control plane (``repro_torch/serverless``:
artifacts, cluster, costs, baselines, preload, offload, traces, latency
and the discrete-event simulator) against the reference's on the same
inputs.

These modules are deterministic host code with the same arithmetic in both
packages, so every comparison is exact (``==``): preload and offload plans
as ``(key, tier, location, value)`` in order, cost meters, traces, the
latency model's byte counts and batching profile for every config, and
each simulated request's times and breakdown, ``dollars`` and
``gpu_byte_s``.  Each test of ``tests/test_serverless.py`` and
``tests/test_traces.py`` has a counterpart here built from the same
inputs; the two CoV-bucket tests and the two workload tests repeat each
other, so each pair is one parametrised test.  The qualitative claims of
``tests/test_system.py`` are held on the port's simulator.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import copy
import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

from repro.configs import get_config as jax_get_config
from repro.core.lora import adapter_bytes as jax_adapter_bytes
from repro.models.config import ModelConfig as JaxConfig
from repro.serverless import artifacts as JA
from repro.serverless import baselines as JB
from repro.serverless import batching as JQ
from repro.serverless import cluster as JC
from repro.serverless import costs as JK
from repro.serverless import latency as JL
from repro.serverless import offload as JO
from repro.serverless import preload as JP
from repro.serverless import simulator as JS
from repro.serverless import traces as JT
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.lora import adapter_bytes
from repro_torch.models.config import ModelConfig
from repro_torch.serverless import artifacts as A
from repro_torch.serverless import baselines as B
from repro_torch.serverless import batching as Q
from repro_torch.serverless import cluster as C
from repro_torch.serverless import costs as K
from repro_torch.serverless import latency as L
from repro_torch.serverless import offload as O
from repro_torch.serverless import preload as P
from repro_torch.serverless import simulator as S
from repro_torch.serverless import traces as T

GiB = 2 ** 30
PORT = dict(A=A, C=C, P=P, O=O)
REF = dict(A=JA, C=JC, P=JP, O=JO)


def _fn(m, fn_id, backbone, rate, bb_gib=10.0):
    """``tests/test_serverless.py::_fn`` in package ``m``."""
    Artifact, Kind = m["A"].Artifact, m["A"].Kind
    arts = [
        Artifact(fn_id, Kind.LIBRARY, "libs", 2 * GiB, 6.5, 0.0),
        Artifact("", Kind.BACKBONE, backbone, int(bb_gib * GiB), 8.0, 0.5),
        Artifact(fn_id, Kind.ADAPTER, f"{fn_id}-a", 64 << 20, 0.05, 0.01),
        Artifact(fn_id, Kind.KERNEL, f"{fn_id}-k", 512 << 20, 0.0, 3.5),
    ]
    return m["P"].FunctionSpec(fn_id, backbone, arts, rate)


def _cluster(m, gpus=2, hbm=24, host=64):
    return m["C"].Cluster(1, gpus, 2, hbm * GiB, host * GiB)


def _key(art):
    return (art.fn_id, art.kind.value, art.name, art.nbytes,
            art.load_remote_s, art.load_host_s)


def _plan(plan):
    return [(_key(p.artifact), p.tier.value, p.location, p.value)
            for p in plan]


def _evictions(plan):
    return None if plan is None else [
        (_key(e.artifact), e.gpu_id, e.dest, e.value_lost) for e in plan]


def _residency(cl):
    return ([(g.gpu_id, sorted(_key(a) for a in g.resident.values()))
             for g in cl.gpus],
            [(c.container_id, sorted(_key(a) for a in c.resident.values()))
             for c in cl.containers])


def _greedy(m, fns, share=True, **cl_kw):
    cl = _cluster(m, **cl_kw)
    return m["P"].greedy_preload(fns(m), cl, share_backbone=share), cl


# ------------------------------------------------------------------ preload
def test_greedy_respects_capacity_and_precedence():
    fns = lambda m: [_fn(m, f"f{i}", "bb", 0.1 + 0.05 * i)  # noqa: E731
                     for i in range(3)]
    plan, cl = _greedy(PORT, fns)
    assert _plan(plan) == _plan(_greedy(REF, fns)[0])
    used_gpu = {}
    for p in plan:
        if p.tier == A.Tier.GPU:
            used_gpu[p.location] = used_gpu.get(p.location, 0) + \
                p.artifact.nbytes
    for gid, used in used_gpu.items():
        assert used <= cl.gpu(gid).hbm_bytes
    bb_gpus = {p.location for p in plan
               if p.artifact.kind == A.Kind.BACKBONE and p.tier == A.Tier.GPU}
    for p in plan:
        if p.artifact.kind == A.Kind.KERNEL:
            assert p.location in bb_gpus
    assert sum(1 for p in plan if p.artifact.kind == A.Kind.BACKBONE
               and p.tier == A.Tier.GPU) == 1


def test_greedy_and_exact_equal_reference_on_small_instance():
    """The greedy and exact plans of the reference's tight instance, plan
    for plan, and the greedy's value within [0.6, 1] x the optimum."""
    def run(m):
        fns = [_fn(m, "f0", "bb", 0.5, bb_gib=12.0),
               _fn(m, "f1", "bb", 0.1, bb_gib=12.0)]
        cl = m["C"].Cluster(1, 1, 1, 16 * GiB, 8 * GiB)
        return (m["P"].greedy_preload(fns, cl, share_backbone=True),
                m["P"].exact_preload(fns, cl, share_backbone=True))
    g, e = run(PORT)
    jg, je = run(REF)
    assert _plan(g) == _plan(jg)
    assert _plan(e) == _plan(je)
    assert P.plan_value(g) == JP.plan_value(jg)
    assert P.plan_value(e) == JP.plan_value(je)
    assert P.plan_value(g) >= 0.6 * P.plan_value(e)
    assert P.plan_value(g) <= P.plan_value(e) + 1e-9


@pytest.mark.parametrize("share", [True, False])
def test_sharing_plans_equal_reference(share):
    fns = lambda m: [_fn(m, f"f{i}", "bb", 0.2)  # noqa: E731
                     for i in range(4)]
    plan, _ = _greedy(PORT, fns, share=share)
    assert _plan(plan) == _plan(_greedy(REF, fns, share=share)[0])


def test_sharing_beats_no_sharing_in_plan_value():
    fns = lambda m: [_fn(m, f"f{i}", "bb", 0.2)  # noqa: E731
                     for i in range(4)]
    v_share = P.plan_value(_greedy(PORT, fns, share=True)[0])
    v_noshare = P.plan_value(_greedy(PORT, fns, share=False)[0])
    assert v_share >= v_noshare


@settings(max_examples=20, deadline=None)
@given(rates=st.lists(st.floats(0.01, 2.0), min_size=1, max_size=4),
       hbm=st.integers(12, 48))
def test_greedy_never_overflows_property(rates, hbm):
    fns = lambda m: [_fn(m, f"f{i}", "bb", r)  # noqa: E731
                     for i, r in enumerate(rates)]
    plan, cl = _greedy(PORT, fns, hbm=hbm)
    assert _plan(plan) == _plan(_greedy(REF, fns, hbm=hbm)[0])
    gpu_used, host_used = {}, {}
    for p in plan:
        d = gpu_used if p.tier == A.Tier.GPU else host_used
        d[p.location] = d.get(p.location, 0) + p.artifact.nbytes
    for g, u in gpu_used.items():
        assert u <= cl.gpu(g).hbm_bytes
    for c, u in host_used.items():
        assert u <= cl.container(c).host_bytes


# ----------------------------------------------------------------- batching
def test_batch_profile_equations():
    prof = Q.BatchProfile(t0=0.4, alpha=0.1, max_batch=12)
    assert prof.t(1) == pytest.approx(0.4)
    assert prof.t(5) == pytest.approx(0.8)
    kw = dict(name="x", family="dense", num_layers=2, d_model=256,
              num_heads=4, num_kv_heads=4, d_ff=512, vocab_size=1000)
    p = Q.profile_function(ModelConfig(**kw), 512, slo=2.0,
                           lat=L.LatencyModel(L.SLICE_HW))
    jp = JQ.profile_function(JaxConfig(**kw), 512, slo=2.0,
                             lat=JL.LatencyModel(JL.SLICE_HW))
    assert dataclasses.astuple(p) == dataclasses.astuple(jp)
    assert p.t(p.max_batch) <= 2.0 + 1e-6


def test_fill_or_expire():
    def run(m):
        q = m.FunctionQueue("f", m.BatchProfile(t0=0.2, alpha=0.05,
                                                max_batch=3))
        q.push(m.Request(0, "f", arrival=0.0, prompt_len=8, output_len=4,
                         slo_ttft=1.0))
        out = [q.expire_deadline(0.0), q.expire_deadline(0.0, cap=0.05)]
        q.push(m.Request(1, "f", 0.1, 8, 4, 1.0))
        q.push(m.Request(2, "f", 0.2, 8, 4, 1.0))
        out.append(q.full())
        out.append([r.req_id for r in q.pop_batch()])
        return out, q.pending
    got, pending = run(Q)
    assert got == run(JQ)[0]
    assert got[0] == pytest.approx(0.8)
    assert got[1] == pytest.approx(0.05)
    assert got[2] and got[3] == [0, 1, 2] and not pending


def test_deadline_margin_priority():
    def run(m):
        sched = m.BatchingScheduler(adaptive=True)
        sched.warm_hint = lambda f: True
        sched.register("tight", m.BatchProfile(0.9, 0.01, 4))
        sched.register("loose", m.BatchProfile(0.1, 0.01, 4))
        sched.push(m.Request(0, "tight", 0.0, 8, 4, slo_ttft=1.0))
        sched.push(m.Request(1, "loose", 0.0, 8, 4, slo_ttft=1.0))
        return [(q.fn_id, q.deadline_margin(0.3, 1))
                for q in sched.ready_queues(now=0.3)]
    got = run(Q)
    assert got == run(JQ)
    assert [f for f, _ in got] == ["tight", "loose"]


@settings(max_examples=25, deadline=None)
@given(t0=st.floats(0.05, 1.0), alpha=st.floats(0.001, 0.2),
       slo=st.floats(0.5, 5.0), n=st.integers(1, 30))
def test_batching_slo_property(t0, alpha, slo, n):
    bmax = max(1, int((slo - t0) / alpha) + 1) if t0 < slo else 1
    prof, jprof = Q.BatchProfile(t0, alpha, bmax), \
        JQ.BatchProfile(t0, alpha, bmax)
    b = min(n, prof.max_batch)
    assert prof.t(b) == jprof.t(b)
    if t0 < slo:
        assert prof.t(b) <= slo + 1e-9


# ----------------------------------------------------------------- offload
def _offload_case(m, arts, need, rates, hbm=24, host=64, pin=()):
    cl = _cluster(m, gpus=1, hbm=hbm, host=host)
    g = cl.gpus[0]
    for a in arts(m):
        g.add(a)
        if a.name in pin:
            g.pinned.add(a.key)
    plan = m["O"].plan_offload(g, need_bytes=need, cluster=cl, rates=rates)
    freed = None if plan is None else m["O"].apply_offload(plan, cl)
    return plan, freed, cl


def _three(m):
    Artifact, Kind = m["A"].Artifact, m["A"].Kind
    return [Artifact("f0", Kind.ADAPTER, "cheap", 8 * GiB, 0.05, 0.01),
            Artifact("f1", Kind.ADAPTER, "hot", 8 * GiB, 4.0, 1.0),
            Artifact("f2", Kind.KERNEL, "k", 4 * GiB, 0.0, 3.5)]


def _check_offload_equal(*args, **kw):
    plan, freed, cl = _offload_case(PORT, *args, **kw)
    jplan, jfreed, jcl = _offload_case(REF, *args, **kw)
    assert _evictions(plan) == _evictions(jplan)
    assert freed == jfreed
    assert _residency(cl) == _residency(jcl)
    return plan, cl


def test_offloader_frees_enough_and_minimizes_value():
    plan, cl = _check_offload_equal(
        _three, 6 * GiB, {"f0": 0.01, "f1": 5.0, "f2": 0.5})
    assert plan is not None
    g = cl.gpus[0]
    assert g.free >= 6 * GiB
    assert ("f1", A.Kind.ADAPTER, "hot") in g.resident


def test_offloader_respects_pins():
    one = lambda m: [m["A"].Artifact(  # noqa: E731
        "f0", m["A"].Kind.ADAPTER, "pinned", 12 * GiB, 1.0, 0.1)]
    plan, _ = _check_offload_equal(one, 8 * GiB, {}, hbm=16,
                                   pin=("pinned",))
    assert plan is None


def test_offload_demotes_models_to_host():
    one = lambda m: [m["A"].Artifact(  # noqa: E731
        "f0", m["A"].Kind.BACKBONE, "bb", 10 * GiB, 8.0, 0.5)]
    plan, cl = _check_offload_equal(one, 8 * GiB, {"f0": 0.1}, hbm=16)
    assert cl.find_host_with(("f0", A.Kind.BACKBONE, "bb")) is not None


# ------------------------------------------------------------------ traces
BUCKETS = {"predictable": (0.0, 1.0), "normal": (1.0, 4.0),
           "bursty": (4.0, float("inf"))}
# (pattern, seed, rate, duration, (lo, hi)): test_serverless.py's loose
# bounds at 0.5 req/s over 4000 s, then test_traces.py's declared buckets
# at 8 req/s over 600 s for three seeds
COV_CASES = [("predictable", 0, 0.5, 4000.0, (0.0, 1.6)),
             ("normal", 0, 0.5, 4000.0, (1.0, 4.5)),
             ("bursty", 0, 0.5, 4000.0, (2.5, 50.0))] + [
    (p, s, 8.0, 600.0, BUCKETS[p]) for p in sorted(T.PATTERNS)
    for s in (0, 1, 7)]


@pytest.mark.parametrize("pattern,seed,rate,duration,bounds", COV_CASES)
def test_cov_lands_in_bucket(pattern, seed, rate, duration, bounds):
    arr = T.gen_arrivals(T.TraceSpec("fnA", pattern, rate, duration), seed)
    jarr = JT.gen_arrivals(JT.TraceSpec("fnA", pattern, rate, duration),
                           seed)
    np.testing.assert_array_equal(arr, jarr)
    cov = T.measured_cov(arr)
    assert cov == JT.measured_cov(jarr)
    if rate == 8.0:
        assert len(arr) > 500
    lo, hi = bounds
    assert lo <= cov <= hi, (pattern, cov)


def test_measured_cov_short_trace_is_zero():
    for arr in (np.array([]), np.array([1.0]), np.array([1.0, 2.0])):
        assert T.measured_cov(arr) == JT.measured_cov(arr) == 0.0


def test_arrivals_sorted_and_bounded():
    spec = T.TraceSpec("fnA", "bursty", 5.0, 120.0)
    arr = T.gen_arrivals(spec, 3)
    np.testing.assert_array_equal(
        arr, JT.gen_arrivals(JT.TraceSpec("fnA", "bursty", 5.0, 120.0), 3))
    assert np.all(np.diff(arr) >= 0)
    assert arr.min() >= 0.0 and arr.max() < spec.duration_s


def test_seeded_generation_deterministic():
    spec = T.TraceSpec("fnA", "normal", 4.0, 300.0)
    a, b, c = (T.gen_arrivals(spec, s) for s in (42, 42, 43))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        a, JT.gen_arrivals(JT.TraceSpec("fnA", "normal", 4.0, 300.0), 42))
    assert len(a) != len(c) or not np.array_equal(a, c)


def test_distinct_functions_get_distinct_streams():
    a = T.gen_arrivals(T.TraceSpec("fnA", "normal", 4.0, 300.0), 0)
    b = T.gen_arrivals(T.TraceSpec("fnB", "normal", 4.0, 300.0), 0)
    np.testing.assert_array_equal(
        b, JT.gen_arrivals(JT.TraceSpec("fnB", "normal", 4.0, 300.0), 0))
    assert len(a) != len(b) or not np.array_equal(a, b)


@pytest.mark.parametrize("n,pattern,rate,duration", [
    (3, "normal", 0.2, 600.0),      # test_serverless.py
    (3, "bursty", 2.0, 60.0),       # test_traces.py
])
def test_workload_merged_sorted_reindexed(n, pattern, rate, duration):
    specs = [T.TraceSpec(f"fn{i}", pattern, rate, duration)
             for i in range(n)]
    wl = T.make_workload(specs, seed=5)
    assert wl == JT.make_workload(
        [JT.TraceSpec(f"fn{i}", pattern, rate, duration) for i in range(n)],
        seed=5)
    assert wl == T.make_workload(specs, seed=5)
    arrivals = [w["arrival"] for w in wl]
    assert arrivals == sorted(arrivals)
    assert [w["req_id"] for w in wl] == list(range(len(wl)))
    assert {w["fn_id"] for w in wl} == {f"fn{i}" for i in range(n)}


# ------------------------------------------------------------------- costs
def test_cost_meter_integration():
    def run(m):
        meter = m.CostMeter()
        meter.set_usage(0.0, gpu_bytes=GiB, host_bytes=0, cpu_cores=0)
        meter.advance(10.0)
        first = meter.gpu_byte_s
        meter.set_usage(10.0, gpu_bytes=0, host_bytes=2 * GiB, cpu_cores=1)
        meter.advance(20.0)
        meter.count_invocation()
        return (first, meter.gpu_byte_s, meter.host_byte_s,
                meter.cpu_core_s, meter.invocations, meter.dollars)
    got = run(K)
    assert got == run(JK)
    first, gpu, host, cpu, _, dollars = got
    assert first == pytest.approx(10.0 * GiB)
    assert gpu == pytest.approx(10.0 * GiB)
    assert host == pytest.approx(20.0 * GiB)
    assert cpu == pytest.approx(10.0)
    assert dollars > 0
    assert K.cost_effectiveness(2.0, dollars) == \
        JK.cost_effectiveness(2.0, dollars)


# ------------------------------------------------------------------ latency
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_latency_model_and_adapter_bytes_equal_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    lat, jlat = L.LatencyModel(L.SLICE_HW), JL.LatencyModel(JL.SLICE_HW)
    assert adapter_bytes(cfg) == jax_adapter_bytes(jcfg)
    assert lat.backbone_bytes(cfg) == jlat.backbone_bytes(jcfg)
    for ctx in (560, 8192):
        assert lat.kv_bytes_per_request(cfg, ctx) == \
            jlat.kv_bytes_per_request(jcfg, ctx)
    assert lat.prefill_t0_alpha(cfg, 512) == jlat.prefill_t0_alpha(jcfg, 512)
    assert lat.decode_s_per_token(cfg, 4, 1024) == \
        jlat.decode_s_per_token(jcfg, 4, 1024)


def test_stand_in_hardware_unchanged():
    """``DEFAULT_HW`` and ``SLICE_HW`` keep the reference's values."""
    assert dataclasses.astuple(L.DEFAULT_HW) == \
        dataclasses.astuple(JL.DEFAULT_HW)
    assert dataclasses.astuple(L.SLICE_HW) == dataclasses.astuple(JL.SLICE_HW)


# --------------------------------------------------------------- simulator
POLICIES = {
    "ServerlessLoRA": (B.SERVERLESS_LORA, JB.SERVERLESS_LORA),
    "ServerlessLLM": (B.SERVERLESS_LLM, JB.SERVERLESS_LLM),
    "InstaInfer": (B.INSTAINFER, JB.INSTAINFER),
    "vLLM": (B.VLLM, JB.VLLM),
    "dLoRA": (B.DLORA, JB.DLORA),
    "ServerlessLoRA-NBS": (B.variant_nbs(), JB.variant_nbs()),
    "ServerlessLoRA-NPL": (B.variant_npl(), JB.variant_npl()),
    "ServerlessLoRA-NDO": (B.variant_ndo(), JB.variant_ndo()),
    "ServerlessLoRA-NAB #2": (B.variant_nab(10, 0.5, "#2"),
                              JB.variant_nab(10, 0.5, "#2")),
}
# the port's measured profile, carried into the reference's Hardware
HARDWARE = {"slice": (L.SLICE_HW, JL.SLICE_HW),
            "h100": (L.H100_HW, JL.Hardware(
                **dataclasses.asdict(L.H100_HW)))}


def _paper_workload(m):
    """``tests/test_system.py::paper_setup``'s workload."""
    specs = ([m.TraceSpec(f"fn7-{i}", "bursty", 0.02, 1200.0, 512, 48, 2.5)
              for i in range(4)] +
             [m.TraceSpec(f"fn13-{i}", "bursty", 0.012, 1200.0, 512, 48,
                          4.0) for i in range(4)])
    return m.make_workload(specs, seed=0)


def _simulate(S_, C_, cfgs, policy, hw, wl):
    l7, l13 = cfgs("llama2_7b"), cfgs("llama2_13b")
    fns = ([S_.FunctionDef(f"fn7-{i}", "llama2-7b", l7) for i in range(4)]
           + [S_.FunctionDef(f"fn13-{i}", "llama2-13b", l13)
              for i in range(4)])
    cl = C_.Cluster(1, 4, 2, hw.hbm_bytes, hw.host_mem_bytes)
    return S_.Simulator(fns, policy, cluster=cl, hw=hw).run(
        copy.deepcopy(wl))


@pytest.fixture(scope="module")
def sims():
    """(hardware, policy name) -> (port SimResult, reference SimResult),
    computed on first use."""
    wl = _paper_workload(T)
    assert wl == _paper_workload(JT)
    cache = {}

    def get(hw_name, name):
        if (hw_name, name) not in cache:
            pol, jpol = POLICIES[name]
            hw, jhw = HARDWARE[hw_name]
            cache[hw_name, name] = (
                _simulate(S, C, get_config, pol, hw, wl),
                _simulate(JS, JC, jax_get_config, jpol, jhw, wl))
        return cache[hw_name, name]
    return get


def _requests(res):
    return [(r.req_id, r.fn_id, r.arrival, r.dispatch, r.first_token,
             r.done, r.cold_start, r.breakdown) for r in res.requests]


@pytest.mark.parametrize("hw_name", sorted(HARDWARE))
@pytest.mark.parametrize("name", list(POLICIES))
def test_simulator_equals_reference(sims, hw_name, name):
    res, ref = sims(hw_name, name)
    assert res.policy == ref.policy == name
    assert len(res.requests) == len(ref.requests) > 0
    assert _requests(res) == _requests(ref)
    assert res.dollars == ref.dollars
    assert res.gpu_byte_s == ref.gpu_byte_s
    assert res.sched_overhead_s == ref.sched_overhead_s
    assert res.breakdown_totals() == ref.breakdown_totals()


# the qualitative claims of tests/test_system.py, on the port's simulator
def test_all_requests_served(sims):
    for name in POLICIES:
        res = sims("slice", name)[0]
        assert not [r for r in res.requests if r.first_token < 0], name


def test_ttft_beats_serverless_baselines(sims):
    ours = sims("slice", "ServerlessLoRA")[0].mean_ttft
    assert ours < 0.7 * sims("slice", "ServerlessLLM")[0].mean_ttft
    assert ours < 0.6 * sims("slice", "InstaInfer")[0].mean_ttft


def test_cost_beats_baselines(sims):
    ours = sims("slice", "ServerlessLoRA")[0].dollars
    assert ours < sims("slice", "ServerlessLLM")[0].dollars
    assert ours < sims("slice", "InstaInfer")[0].dollars
    assert ours < 0.5 * sims("slice", "vLLM")[0].dollars


def test_cost_effectiveness_best_overall(sims):
    ours = sims("slice", "ServerlessLoRA")[0].cost_effectiveness
    for other in ("ServerlessLLM", "InstaInfer", "vLLM", "dLoRA"):
        assert ours > sims("slice", other)[0].cost_effectiveness, other


def test_ablations_degrade(sims):
    full = sims("slice", "ServerlessLoRA")[0]
    nbs = sims("slice", "ServerlessLoRA-NBS")[0]
    npl = sims("slice", "ServerlessLoRA-NPL")[0]
    assert nbs.dollars > 1.2 * full.dollars, "sharing saves cost"
    assert npl.mean_ttft > 1.5 * full.mean_ttft, "pre-loading saves TTFT"
    assert full.cost_effectiveness >= max(nbs.cost_effectiveness,
                                          npl.cost_effectiveness)


def test_serverful_has_zero_cold_start(sims):
    for name in ("vLLM", "dLoRA"):
        assert sims("slice", name)[0].mean_cold_start == 0.0


def test_slo_violation_bounded(sims):
    assert sims("slice", "ServerlessLoRA")[0].slo_violation_rate <= 0.15
