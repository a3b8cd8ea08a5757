"""Hybrid REC/SSD serving in the port's runtime against the reference's
(``tests/test_hybrid_serving.py``, case for case), on the CPU under
deterministic fake clocks, with the reference's SMOKE RecurrentGemma
(REC, REC, ATTN) and Mamba-2 (SSD only) weights carried over by the
bridge (float32, LoRA B drawn nonzero).

Tolerance of the logits and state rows: 1e-5 x max(1, max |reference|),
as in ``tests/test_torch_hybrid.py``; greedy token streams are equal.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeTimer, build_model, make_runtime
from repro.checkpoint.store import _flatten, _unflatten
from repro.core.engine import make_serve_step as jax_serve_step
from repro.core.engine import make_state_extract_fn as jax_state_extract
from repro.serverless.batching import Request as JaxRequest
from repro.serverless.traces import TraceSpec, make_workload
from repro.serving import ServeRequest as JaxServeRequest
from repro.serving import replay_trace as jax_replay_trace
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.core.engine import (make_serve_step, make_state_extract_fn,
                                     make_state_insert_fn,
                                     make_state_reset_fn)
from repro_torch.models.cache import (init_paged_cache, slot_state_spec,
                                      state_bytes_per_slot)
from repro_torch.models.config import REC, SSD
from repro_torch.serverless.batching import Request
from repro_torch.serving import (CompileGuard, ContinuousRuntime,
                                 GraphedDispatch, ServeRequest,
                                 ServingConfig, replay_trace)

ARCHS = {"rec": "recurrentgemma_9b", "ssd": "mamba2_780m"}
NUM_SLOTS, BS, MB = 3, 8, 4
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """'rec' / 'ssd' -> (jax cfg, jax params, torch cfg, torch params)."""
    out = {}
    for name, arch in ARCHS.items():
        cfg_j, params = build_model(arch)
        flat = _flatten(params)
        rng = np.random.default_rng(0)
        for k, v in flat.items():
            if "/lora/" in k and k.endswith("/b"):
                flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    v.dtype)
        cfg_t = get_smoke(arch).with_(dtype="float32")
        out[name] = (cfg_j, _unflatten(flat), cfg_t,
                     params_from_flat(flat, cfg_t, device="cpu"))
    return out


def _scfg(**kw):
    d = dict(num_slots=NUM_SLOTS, block_size=BS, num_blocks=32,
             max_blocks_per_slot=MB, prefill_chunk=8, decode_chunk=2)
    d.update(kw)
    return d


def _port_rt(cfg, params, **kw):
    return ContinuousRuntime(cfg, params, ServingConfig(**_scfg(**kw)),
                             device="cpu", timer=FakeTimer())


def _ref_rt(cfg, params, **kw):
    return make_runtime(cfg, params, use_kernel=False, timer=FakeTimer(),
                        **_scfg(**kw))


def _req(rid, L, out, cls=Request):
    return cls(req_id=rid, fn_id="fn0", arrival=0.0, prompt_len=L,
               output_len=out, slo_ttft=30.0)


def _admit_both(models, name, L, n=2, seed=1, **kw):
    cfg_j, pj, cfg_t, pt = models[name]
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg_t.vocab_size, L, dtype=np.int32)
               for _ in range(n)]
    rt_j, rt_t = _ref_rt(cfg_j, pj, **kw), _port_rt(cfg_t, pt, **kw)
    res_j = rt_j.try_admit([JaxServeRequest(
        prompt=prompts[i], adapter=i + 1, request=_req(i, L, 8, JaxRequest))
        for i in range(n)])
    res_t = rt_t.try_admit([ServeRequest(
        prompt=prompts[i], adapter=i + 1, request=_req(i, L, 8))
        for i in range(n)])
    return rt_j, rt_t, res_j, res_t


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL * scale:.3e}"


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_hybrid_decode_matches_reference_runtime(models, name):
    """Chunked paged prefill + slot-state rows, then five manual decode
    steps over the slot mirrors: first tokens equal, every step's logits
    within tolerance of the reference runtime's."""
    rt_j, rt_t, res_j, res_t = _admit_both(models, name, L=10)
    assert res_t.slot_ids == res_j.slot_ids == [0, 1]
    assert res_t.first_tokens == res_j.first_tokens
    cfg_j, pj, cfg_t, pt = models[name]
    serve_j, serve_t = jax_serve_step(cfg_j), make_serve_step(cfg_t)
    tok = rt_t.slots.tokens.copy()
    pos = rt_t.slots.pos.copy()
    srows = np.arange(NUM_SLOTS, dtype=np.int32)
    cache_j = rt_j.cache
    for step in range(5):
        lj, cache_j = serve_j(
            pj, jnp.asarray(tok), cache_j, jnp.asarray(pos),
            adapter_idx=jnp.asarray(rt_j.slots.adapter),
            block_tbl=jnp.asarray(rt_j.slots.block_tbl),
            use_paged_kernel=False, state_rows=jnp.asarray(srows))
        lt, _ = serve_t(pt, torch.from_numpy(tok), rt_t.cache,
                        torch.from_numpy(pos),
                        adapter_idx=torch.from_numpy(rt_t.slots.adapter),
                        block_tbl=torch.from_numpy(rt_t.slots.block_tbl),
                        state_rows=torch.from_numpy(srows))
        _close(lt.numpy()[:2], np.asarray(lj)[:2], f"step {step}")
        nxt = np.asarray(lj).argmax(-1).astype(np.int32)
        assert (lt.numpy()[:2].argmax(-1) == nxt[:2]).all()
        tok[:2], pos[:2] = nxt[:2], pos[:2] + 1


def _layer_rows(cache_j, cfg_j, i):
    n, j = divmod(i, len(cfg_j.pattern))
    return cache_j["periods"][f"p{j}"], n


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_hybrid_prefill_state_matches_reference(models, name):
    """The rows chunked prefill leaves (two 8-token chunks, carried state
    between them): ``make_state_extract_fn`` of both runtimes agree."""
    rt_j, rt_t, res_j, res_t = _admit_both(models, name, L=12, seed=3)
    cfg_j, _, cfg_t, _ = models[name]
    ext_j, ext_t = jax_state_extract(cfg_j), make_state_extract_fn(cfg_t)
    for row in (0, 1):
        got, want = ext_t(rt_t.cache, row), ext_j(rt_j.cache, row)
        for i, kind in enumerate(cfg_t.layer_kinds):
            if kind not in (REC, SSD):
                assert got[i] is None
                continue
            layer, n = _layer_rows(want, cfg_j, i)
            for k in slot_state_spec(kind, cfg_t):
                _close(got[i][k].numpy(), np.asarray(layer[k][n]),
                       f"row {row} layer {i} {k}")


def _trace(vocab, seed=11):
    specs = [TraceSpec(f"fn{a}", "bursty", 1.5, 5.0, prompt_len=12,
                       output_len=8, slo_ttft=30.0) for a in range(2)]
    work = make_workload(specs, seed=seed)
    rng = np.random.default_rng(seed)
    prompts = {w["req_id"]: rng.integers(0, vocab, w["prompt_len"]
                                         ).astype(np.int32) for w in work}
    return work, prompts


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_hybrid_replay_matches_reference(models, name):
    """A bursty 2-adapter trace end to end: the same tokens as the
    reference runtime, slots and blocks released, both dispatches
    captured once under the guard."""
    cfg_j, pj, cfg_t, pt = models[name]
    work, prompts = _trace(cfg_t.vocab_size)
    assert len(work) > 4
    fn_adapter = {f"fn{a}": a for a in range(2)}
    kw = dict(num_slots=4, max_blocks_per_slot=6, prefill_chunk=16,
              decode_chunk=4)
    rt_j, rt_t = _ref_rt(cfg_j, pj, **kw), _port_rt(cfg_t, pt, **kw)
    sink_j, sink_t = {}, {}
    jax_replay_trace(rt_j, work, fn_adapter, prompts=prompts,
                     slo_abandon=False, token_sink=sink_j)
    with CompileGuard({"decode": 1, "prefill": 1}, runtime=rt_t):
        res, _ = replay_trace(rt_t, work, fn_adapter, prompts=prompts,
                              slo_abandon=False, token_sink=sink_t)
    assert sink_t == sink_j and len(sink_t) == len(work)
    assert rt_t.slots.num_active == 0 and rt_t.pool.in_use == 0
    assert rt_t.check_invariants(res.requests)["problems"] == []
    assert rt_t.stats["recomputed_tokens"] == \
        rt_j.stats["recomputed_tokens"]


def test_hybrid_stall_does_not_corrupt_output(models):
    """A stalled hybrid slot, after resuming, emits what it emits on an
    ample pool (its state row points at the garbage row for the stalled
    chunk), and what the reference runtime emits on the same tight
    pool."""
    cfg_j, pj, cfg_t, pt = models["rec"]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg_t.vocab_size, 8, dtype=np.int32)
               for _ in range(2)]
    kw = dict(num_slots=2, block_size=4, max_blocks_per_slot=4,
              prefill_chunk=8, decode_chunk=4)

    def run(make, SR, R, params, num_blocks):
        rt = make(params, num_blocks=num_blocks, **kw)
        res = rt.try_admit([SR(prompt=prompts[i], adapter=i,
                               request=_req(i, 8, 9, R)) for i in range(2)])
        out = {sid: [tok] for sid, tok in zip(res.slot_ids,
                                              res.first_tokens)}
        stalls = 0
        for _ in range(12):
            d = rt.decode()
            if d is None:
                break
            stalls += len(d.stalled)
            for sid, toks in d.emitted.items():
                out[sid].extend(toks)
        assert rt.pool.in_use == 0
        return out, stalls

    def port(params, **k):
        return _port_rt(cfg_t, params, **k)

    def ref(params, **k):
        return _ref_rt(cfg_j, params, **k)

    tight, tight_stalls = run(port, ServeRequest, Request, pt, 8)
    ample, ample_stalls = run(port, ServeRequest, Request, pt, 32)
    ref_tight, ref_stalls = run(ref, JaxServeRequest, JaxRequest, pj, 8)
    assert tight_stalls > 0 and tight_stalls == ref_stalls
    assert ample_stalls == 0
    assert tight == ample == ref_tight


def test_slot_reuse_reads_zero_state(models):
    """Serving B after A on the same slot equals serving B on a fresh
    runtime: chunk 0 (position 0) reads zero state in-step."""
    _, _, cfg, params = models["ssd"]
    rng = np.random.default_rng(9)
    pa = rng.integers(0, cfg.vocab_size, 10, dtype=np.int32)
    pb = rng.integers(0, cfg.vocab_size, 10, dtype=np.int32)

    def serve_b(warm_first):
        rt = _port_rt(cfg, params, prefix_sharing=False)
        if warm_first:
            res = rt.try_admit([ServeRequest(prompt=pa, adapter=1,
                                             request=_req(0, 10, 4))])
            assert res.slot_ids == [0]
            while rt.decode() is not None:
                pass
            assert rt.slots.num_active == 0
            assert rt.cache[0]["ssm"][0].abs().sum() > 0   # A's leftovers
        res = rt.try_admit([ServeRequest(prompt=pb, adapter=2,
                                         request=_req(1, 10, 6))])
        assert res.slot_ids == [0]
        toks = [res.first_tokens[0]]
        for _ in range(6):
            d = rt.decode()
            if d is None:
                break
            toks.extend(d.emitted.get(0, []))
        return toks

    assert serve_b(True) == serve_b(False)


def test_state_insert_extract_reset_roundtrip(models):
    cfg = models["rec"][2]
    cache = init_paged_cache(cfg, 8, 4, num_slots=2, device="cpu")
    rng = np.random.default_rng(0)
    states = [None if kind not in (REC, SSD) else
              {k: torch.from_numpy(rng.normal(size=shp).astype(np.float32))
               for k, (shp, _) in slot_state_spec(kind, cfg).items()}
              for kind in cfg.layer_kinds]
    insert = make_state_insert_fn(cfg)
    extract = make_state_extract_fn(cfg)
    reset = make_state_reset_fn(cfg)
    insert(cache, states, 1)
    got, other = extract(cache, 1), extract(cache, 0)
    for i, kind in enumerate(cfg.layer_kinds):
        if kind not in (REC, SSD):
            assert got[i] is None
            continue
        for k in states[i]:
            assert torch.equal(got[i][k], states[i][k])
            assert not other[i][k].any()          # row 0 untouched
    reset(cache, torch.tensor([1]))
    for i, kind in enumerate(cfg.layer_kinds):
        if kind in (REC, SSD):
            for t in extract(cache, 1)[i].values():
                assert not t.any()


def test_state_bytes_accounting(models):
    """``state_bytes_per_slot`` against the measured bytes of one slot's
    extracted rows and the hand-computed SMOKE totals (the reference's
    4096 and 71680)."""
    for name, expect in (("rec", 4096), ("ssd", 71680)):
        cfg = models[name][2]
        assert state_bytes_per_slot(cfg) == expect, cfg.name
        cache = init_paged_cache(cfg, 8, 4, num_slots=1, device="cpu")
        ext = make_state_extract_fn(cfg)(cache, 0)
        measured = sum(t.numel() * t.element_size() for layer in ext
                       if layer is not None for t in layer.values())
        assert measured == expect


def test_attention_free_stack_not_kv_bounded(models):
    """A pure-SSD stack charges no blocks, never stalls, runs without
    prefix sharing, and is not capped by the block table: a prompt far
    past max_blocks_per_slot * block_size serves, with the reference's
    tokens; a hybrid stack keeps the table's gate."""
    cfg_j, pj, cfg, params = models["ssd"]
    rt = _port_rt(cfg, params)              # table cap would be 4 * 8 = 32
    assert not rt.needs_kv and rt.prefix is None
    L = 70
    assert rt.fits(L, 8) and rt.admit_cost_blocks(L) == 0
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, L,
                                               dtype=np.int32)
    outs = []
    for rt_, SR, R in ((rt, ServeRequest, Request),
                       (_ref_rt(cfg_j, pj), JaxServeRequest, JaxRequest)):
        res = rt_.try_admit([SR(prompt=prompt, adapter=1,
                                request=_req(0, L, 8, R))])
        assert res is not None and res.slot_ids == [0]
        assert rt_.pool.in_use == 0
        toks = list(res.first_tokens)
        for _ in range(8):
            d = rt_.decode()
            if d is None:
                break
            assert not d.stalled and not d.aborted
            toks += [t for v in d.emitted.values() for t in v]
        assert len(toks) == 8
        assert rt_.slots.num_active == 0 and rt_.pool.in_use == 0
        outs.append(toks)
    assert outs[0] == outs[1]
    assert rt.stats["shared_tokens"] == 0
    rt2 = _port_rt(models["rec"][2], models["rec"][3])
    assert rt2.needs_kv and not rt2.fits(L, 8)


def test_hybrid_requires_aligned_prefill_chunk(models):
    cfg, params = models["rec"][2], models["rec"][3]
    with pytest.raises(ValueError, match="ssm_chunk"):
        _port_rt(cfg.with_(ssm_chunk=16), params)     # prefill_chunk 8


def test_compile_guard_holds_over_hybrid_dispatches(models):
    """Both dispatches of a hybrid runtime are ``GraphedDispatch``es whose
    one key takes the state-row vector as one more staged input: prompts
    of every length, a partial admission group and stalled chunks (state
    rows pointed at the garbage row) all reuse it."""
    cfg, params = models["rec"][2], models["rec"][3]
    rt = _port_rt(cfg, params, num_slots=2, block_size=4, num_blocks=8,
                  max_blocks_per_slot=4, prefill_chunk=8, decode_chunk=4)
    assert isinstance(rt._decode, GraphedDispatch)
    assert isinstance(rt._prefill, GraphedDispatch)
    rng = np.random.default_rng(6)
    stalls = 0
    with CompileGuard({"decode": 1, "prefill": 1}, runtime=rt) as guard:
        for n, L, out in ((2, 8, 9), (1, 3, 4), (2, 10, 3)):
            res = rt.try_admit([ServeRequest(
                prompt=rng.integers(0, cfg.vocab_size, L, dtype=np.int32),
                adapter=i, request=_req(i, L, out)) for i in range(n)])
            assert res is not None and len(res.first_tokens) == n
            while (d := rt.decode()) is not None:
                stalls += len(d.stalled)
    rep = guard.report()
    assert rep["decode_compiles"] == 1 and rep["prefill_compiles"] == 1
    assert stalls > 0
    assert rt.pool.in_use == 0 and rt.slots.num_active == 0
