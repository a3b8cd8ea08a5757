"""Sliding-window reclamation in the port's serving runtime against the
reference's (``repro.serving.runtime``), both on the CPU under
deterministic fake clocks, on SMOKE Llama with an 8-token window and on
Mixtral SMOKE (sparse MoE, 16-token window), with the reference's own
weights carried over by the bridge (LoRA B drawn nonzero).

After every decode chunk the two runtimes must hold the same pool: equal
(used, cached, free) block counts; and they must emit equal greedy
tokens, count the same ``reclaimed_blocks``, and balance their books.
The cases: a shared-prefix multi-adapter replay on an ample and a tight
pool, the shared-block decrement of ``tests/test_prefix_sharing.py``,
``window_reclamation=False``, and a preemption of a slot that already
reclaimed blocks (its demotion must stop at the first -1 entry).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest
import torch

from conftest import FakeTimer, build_model, make_runtime
from repro.checkpoint.store import _flatten, _unflatten
from repro.serverless.batching import Request as JaxRequest
from repro.serving import ServeRequest as JaxServeRequest
from repro.serving import replay_trace as jax_replay_trace
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.models.cache import paging_unsupported_reason
from repro_torch.serverless.batching import Request
from repro_torch.serving import (ContinuousRuntime, RobustConfig,
                                 ServeRequest, ServingConfig, replay_trace)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE-sized tensors: one intra-op thread (the test workers share the
    machine's cores); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# name -> (reference arch, config overrides)
CONFIGS = {"llama-window8": ("llama2_7b", dict(sliding_window=8)),
           "mixtral": ("mixtral_8x22b", {})}


@pytest.fixture(scope="module")
def models():
    """name -> (jax cfg, jax params, torch cfg, torch params)."""
    out = {}
    for name, (arch, kw) in CONFIGS.items():
        cfg_j, params = build_model(arch, **kw)
        flat = _flatten(params)
        rng = np.random.default_rng(0)
        for k, v in flat.items():
            if "/lora/" in k and k.endswith("/b"):
                flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    v.dtype)
        cfg_t = get_smoke(arch).with_(dtype="float32", **kw)
        out[name] = (cfg_j, _unflatten(flat), cfg_t,
                     params_from_flat(flat, cfg_t, device="cpu"))
    return out


def _port_runtime(cfg, params, **kw):
    scfg = dict(num_slots=4, block_size=8, num_blocks=32,
                max_blocks_per_slot=6, prefill_chunk=16, decode_chunk=4)
    scfg.update(kw)
    return ContinuousRuntime(cfg, params, ServingConfig(**scfg),
                             device="cpu", timer=FakeTimer())


def _trail(rt):
    """Record the pool's (used, cached, free) after every decode chunk."""
    trail, decode = [], rt.decode

    def recorded():
        out = decode()
        trail.append((rt.pool.in_use, rt.pool.num_cached, rt.pool.num_free))
        return out

    rt.decode = recorded
    return trail


def _trace(vocab, n_fn=3, per_fn=3, seed=11):
    """Per-adapter 16-token system prompts + private suffixes, prompts and
    outputs long enough that every request decodes past the window."""
    rng = np.random.default_rng(seed)
    system = {f: rng.integers(0, vocab, 16).astype(np.int32)
              for f in range(n_fn)}
    work, prompts = [], {}
    rid = 0
    for _ in range(per_fn):
        for f in range(n_fn):
            suffix = rng.integers(0, vocab, int(rng.integers(4, 15)))
            prompts[rid] = np.concatenate([system[f], suffix]).astype(
                np.int32)
            work.append(dict(req_id=rid, fn_id=f"fn{f}",
                             arrival=0.002 * rid,
                             prompt_len=len(prompts[rid]),
                             output_len=int(rng.integers(10, 17)),
                             slo_ttft=100.0))
            rid += 1
    return work, prompts, {f"fn{f}": f for f in range(n_fn)}


def _replay_ref(models, name, **scfg):
    cfg_j, pj, cfg_t, _ = models[name]
    work, prompts, fn_adapter = _trace(cfg_t.vocab_size)
    sink = {}
    rt = make_runtime(cfg_j, pj, timer=FakeTimer(), **scfg)
    trail = _trail(rt)
    res, _ = jax_replay_trace(rt, work, fn_adapter, prompts=prompts,
                              token_sink=sink)
    return rt, res, sink, trail


def _replay_port(models, name, **scfg):
    _, _, cfg_t, pt = models[name]
    work, prompts, fn_adapter = _trace(cfg_t.vocab_size)
    sink = {}
    rt = _port_runtime(cfg_t, pt, **scfg)
    trail = _trail(rt)
    res, _ = replay_trace(rt, work, fn_adapter, prompts=prompts,
                          token_sink=sink)
    return rt, res, sink, trail


def test_windowed_configs_are_served():
    """The refusal of windowed configs (F1) is lifted: Mixtral SMOKE and
    a windowed Llama page like any attention stack."""
    for name, (arch, kw) in CONFIGS.items():
        assert paging_unsupported_reason(get_smoke(arch).with_(**kw)) is None


@pytest.mark.parametrize("num_blocks", [32, 8, 7])  # ample / stalls / evicts
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_windowed_replay_matches_reference(models, name, num_blocks):
    rt_j, res_j, sink_j, trail_j = _replay_ref(models, name,
                                               num_blocks=num_blocks)
    rt_t, res_t, sink_t, trail_t = _replay_port(models, name,
                                                num_blocks=num_blocks)
    assert rt_j.stats["reclaimed_blocks"] > 0
    assert rt_t.stats["reclaimed_blocks"] == rt_j.stats["reclaimed_blocks"]
    assert trail_t == trail_j
    assert sink_t == sink_j
    assert rt_t.stats["stall_steps"] == rt_j.stats["stall_steps"]
    assert rt_t.stats["shared_block_maps"] == \
        rt_j.stats["shared_block_maps"]
    assert [sorted(r.breakdown) for r in res_t.requests] == \
        [sorted(r.breakdown) for r in res_j.requests]
    report = rt_t.check_invariants(res_t.requests)
    assert report["problems"] == []
    assert report["pool"]["live"] == 0 and report["slots_active"] == 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reclamation_off_matches_reference(models, name):
    """``window_reclamation=False`` holds every block to the end, as the
    reference's does, and emits the same tokens as the reclaiming run."""
    rt_j, _, sink_j, trail_j = _replay_ref(models, name,
                                           window_reclamation=False)
    rt_t, _, sink_t, trail_t = _replay_port(models, name,
                                            window_reclamation=False)
    assert rt_t.stats["reclaimed_blocks"] == 0 == \
        rt_j.stats["reclaimed_blocks"]
    assert trail_t == trail_j
    assert sink_t == sink_j
    _, _, sink_on, trail_on = _replay_port(models, name)
    assert sink_on == sink_t
    assert max(u for u, _, _ in trail_on) < max(u for u, _, _ in trail_t)


def _req(rid, prompt_len, output_len, cls=Request):
    return cls(req_id=rid, fn_id="fn0", arrival=0.0, prompt_len=prompt_len,
               output_len=output_len, slo_ttft=30.0)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_shared_block_reclaim_decrements_like_the_reference(models, name):
    """A shared prompt block sliding out of one slot's window drops only
    that slot's reference; the staggered sharer keeps decoding, and on
    drain every block is released exactly once (the reference's
    test_window_reclamation_of_shared_blocks_decrements, both runtimes)."""
    cfg_j, pj, cfg_t, pt = models[name]
    prompt = np.random.default_rng(17).integers(
        0, cfg_t.vocab_size, 16).astype(np.int32)      # 2 full blocks
    scfg = dict(num_slots=2, block_size=8, num_blocks=32,
                max_blocks_per_slot=8, prefill_chunk=16, decode_chunk=4)
    rt_j = make_runtime(cfg_j, pj, timer=FakeTimer(), **scfg)
    rt_t = _port_runtime(cfg_t, pt, **scfg)
    runs = []
    for rt, SR, R in ((rt_j, JaxServeRequest, JaxRequest),
                      (rt_t, ServeRequest, Request)):
        r0 = rt.try_admit([SR(prompt=prompt, adapter=0,
                              request=_req(0, 16, 30, R))])
        trail, emitted = [], {}
        for step in range(16):
            if step == 3:               # slot 0 runs ahead of the sharer
                r1 = rt.try_admit([SR(prompt=prompt, adapter=0,
                                      request=_req(1, 16, 30, R))])
            d = rt.decode()
            if d is None:
                break
            for sid, toks in d.emitted.items():
                emitted.setdefault(sid, []).extend(toks)
            trail.append((rt.pool.in_use, rt.pool.num_cached,
                          rt.pool.num_free, rt.stats["reclaimed_blocks"]))
        runs.append((r0.slot_ids, r1.slot_ids, r1.shared_blocks, trail,
                     emitted))
        assert rt.slots.num_active == 0 and rt.pool.in_use == 0
    assert runs[1] == runs[0]
    assert runs[0][2][0] >= 1 and runs[0][3][-1][3] > 0


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_preempting_a_reclaimed_slot_truncates_its_demotion(models, name):
    """A slot that already reclaimed its leading blocks is preempted: its
    demotion chain stops at the first -1 entry (trie chains start at block
    0), so it demotes nothing, as the reference's; the books then equal
    the reference's and a re-admission of the same prompt emits the same
    tokens."""
    cfg_j, pj, cfg_t, pt = models[name]
    window = cfg_t.sliding_window
    prompt = np.random.default_rng(19).integers(
        0, cfg_t.vocab_size, 12).astype(np.int32)
    scfg = dict(num_slots=2, block_size=8, num_blocks=32,
                max_blocks_per_slot=8, prefill_chunk=16, decode_chunk=4,
                preemption=True)
    rt_j = make_runtime(cfg_j, pj, timer=FakeTimer(), **scfg)
    rt_t = _port_runtime(cfg_t, pt, **scfg)
    books = []
    for rt, SR, R in ((rt_j, JaxServeRequest, JaxRequest),
                      (rt_t, ServeRequest, Request)):
        a = rt.try_admit([SR(prompt=prompt, adapter=1,
                             request=_req(0, 12, 40, R))])
        sid = a.slot_ids[0]
        emitted = []
        while rt.slots.states[sid].reclaimed == 0:
            emitted += rt.decode().emitted[sid]
        st = rt.slots.states[sid]
        assert st.blocks[0] == -1 and st.pos - window + 1 >= 8
        trie_before = len(rt.prefix)
        rt.preempt(sid)
        books.append((emitted, st.reclaimed, rt.stats["demoted_blocks"],
                      len(rt.prefix) - trie_before, rt.pool.in_use,
                      rt.pool.num_cached, rt.pool.num_free))
        again = rt.try_admit([SR(prompt=prompt, adapter=1,
                                 request=_req(1, 12, 40, R))])
        out = {}
        while (d := rt.decode()) is not None:
            for s, toks in d.emitted.items():
                out.setdefault(s, []).extend(toks)
        books.append((again.first_tokens, again.shared_blocks, out,
                      rt.stats["reclaimed_blocks"]))
        assert rt.pool.in_use == 0
    assert books[2:] == books[:2]
    assert books[0][2] == 0                    # nothing demoted


def test_reclaim_and_release_skip_the_placeholders():
    from repro_torch.serving.slots import SlotState, SlotTable
    table = SlotTable(num_slots=2, max_blocks=6)
    st = SlotState(sid=1, req=_req(0, 20, 8), adapter=0, prompt_len=20,
                   budget=8, pos=20, blocks=[4, 5, 6], last_token=0)
    table.bind(st, 0)
    assert table.reclaim(1, 2) == [4, 5]
    assert table.reclaim(1, 2) == []            # idempotent
    assert st.blocks == [-1, -1, 6] and st.reclaimed == 2
    assert table.block_tbl[1, :3].tolist() == [-1, -1, 6]
    table.grow(1, 9)                            # appends after them
    assert table.block_tbl[1, :4].tolist() == [-1, -1, 6, 9]
    assert table.release(1) == [6, 9]
    assert (table.block_tbl[1] == -1).all()


def test_window_reclamation_is_a_serving_config_field():
    assert ServingConfig().window_reclamation is True
    scfg = ServingConfig(window_reclamation=False, preemption=True)
    assert scfg.window_reclamation is False
    assert scfg.robust == RobustConfig(preemption=True)
