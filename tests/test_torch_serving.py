"""Host-side serving state of the port (block pool, prefix trie — the unit
tests of test_prefix_sharing.py / test_serving.py run against the port's
copies), and the main path end to end: the same shared-prefix
multi-adapter trace replayed through the reference's ContinuousRuntime and
the port's on the CPU, under deterministic fake clocks, must admit and
reject the same requests and emit the same greedy token streams.
"""
import numpy as np
import pytest
import torch

from conftest import FakeTimer, build_model, make_runtime
from repro.checkpoint.store import _flatten, _unflatten
from repro.serving import replay_trace as jax_replay_trace
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.models.cache import GARBAGE_BLOCK
from repro_torch.serving import (BlockPool, ContinuousRuntime, PrefixCache,
                                 ServeRequest, ServingConfig,
                                 blocks_for_tokens, replay_trace)

CFG_T = get_smoke("llama2_7b").with_(dtype="float32")


# ------------------------------------------------------------- block pool
def test_block_pool_alloc_free_invariants():
    pool = BlockPool(num_blocks=8, block_size=4)
    assert pool.available == 7            # block 0 reserved for garbage
    a = pool.alloc(3)
    b = pool.alloc(2)
    assert GARBAGE_BLOCK not in a + b
    assert len(set(a + b)) == 5
    assert pool.alloc(3) is None          # all-or-nothing
    assert pool.in_use == 5
    pool.free(b)
    with pytest.raises(KeyError):
        pool.free(b)                      # double free
    with pytest.raises(KeyError):
        pool.free([GARBAGE_BLOCK])
    pool.free(a)
    assert pool.in_use == 0 and pool.available == 7


def test_blocks_for_tokens():
    assert [blocks_for_tokens(n, 8) for n in (0, 1, 8, 9)] == [0, 1, 1, 2]


def test_block_pool_free_and_share_are_atomic():
    pool = BlockPool(num_blocks=8, block_size=4)
    a = pool.alloc(3)
    snap = (list(pool._free), dict(pool._ref))
    with pytest.raises(KeyError):
        pool.free([a[0], a[1], 99])
    with pytest.raises(KeyError):
        pool.free([a[0], a[0]])
    with pytest.raises(KeyError):
        pool.share([a[0], 99])
    assert (list(pool._free), dict(pool._ref)) == snap


def test_refcount_share_and_cached_lifecycle():
    evicted = []
    pool = BlockPool(num_blocks=6, block_size=4)
    pool.cache_hook = lambda b: True
    pool.evict_hook = evicted.append
    a = pool.alloc(2)
    pool.share(a)
    pool.free(a)                          # 2 -> 1: still live
    assert pool.in_use == 2
    pool.free(a)                          # -> cached
    assert pool.in_use == 0 and pool.num_cached == 2
    pool.share([a[1]])                    # revive from cached
    assert pool.refcount(a[1]) == 1
    got = pool.alloc(4)                   # free list of 3 + evicts a[0]
    assert evicted == [a[0]]
    pool.free(got + [a[1]])
    with pytest.raises(RuntimeError):
        pool.alloc(1) and pool.reset()    # live blocks: reset refuses


def test_prefix_cache_match_register_forget():
    pc = PrefixCache(block_size=4)
    toks = np.arange(10, dtype=np.int32)
    assert pc.match(0, toks) == ([], None)
    assert pc.register(0, toks, [5, 6, 7], 0, None) == [5, 6]
    assert pc.match(0, toks)[0] == [5, 6]
    assert pc.match(1, toks)[0] == []           # keyed by adapter
    assert pc.covered_tokens(0, toks[:6]) == 4
    assert pc.register(0, toks, [9, 10], 0, None) == []  # existing wins
    pc.forget_block(5)
    assert pc.match(0, toks)[0] == []
    pc.forget_block(6)
    assert len(pc) == 0


# --------------------------------------------------------- runtime units
@pytest.fixture(scope="module")
def models():
    """Reference SMOKE params (3-adapter bank) with nonzero LoRA B, in both
    packages."""
    cfg_j, params = build_model("llama2_7b")
    flat = _flatten(params)
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if "/lora/" in k and k.endswith("/b"):
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
    return cfg_j, _unflatten(flat), params_from_flat(flat, CFG_T,
                                                     device="cpu")


def _port_runtime(params, **kw):
    scfg = dict(num_slots=4, block_size=8, num_blocks=32,
                max_blocks_per_slot=6, prefill_chunk=16, decode_chunk=4)
    scfg.update(kw)
    return ContinuousRuntime(CFG_T, params, ServingConfig(**scfg),
                             device="cpu", timer=FakeTimer())


def test_admission_rejects_and_finish_at_prefill(models):
    rt = _port_runtime(models[2])
    rng = np.random.default_rng(4)
    res = rt.try_admit([
        ServeRequest(prompt=rng.integers(0, 512, 10), adapter=1,
                     max_new_tokens=1),              # finishes at prefill
        ServeRequest(prompt=rng.integers(0, 512, 45), adapter=0,
                     max_new_tokens=8),              # exceeds 48-token cap
        ServeRequest(prompt=rng.integers(0, 512, 5), adapter=3,
                     max_new_tokens=2),              # outside 3-slot bank
        ServeRequest(prompt=rng.integers(0, 512, 20), adapter=2,
                     max_new_tokens=3)])
    assert res.slot_ids[0] == -1 and res.slot_ids[1] >= 0
    assert len(res.rejected) == 2
    assert rt.stats["rejected_too_long"] == 1
    assert rt.stats["rejected_unknown_adapter"] == 1
    while rt.decode() is not None:
        pass
    assert rt.check_invariants()["pool"]["live"] == 0
    with pytest.raises(ValueError, match="AdapterRegistry"):
        rt.try_admit([ServeRequest(prompt=[1, 2], adapter="tenant-a")])


# ------------------------------------------------------------ end to end
def _trace(n_fn=3, per_fn=3, seed=7):
    """Per-adapter 16-token system prompts + private suffixes; one request
    too long for the slot capacity, one on an adapter outside the bank."""
    rng = np.random.default_rng(seed)
    system = {f: rng.integers(0, 512, 16).astype(np.int32)
              for f in range(n_fn)}
    work, prompts = [], {}
    rid = 0
    for i in range(per_fn):
        for f in range(n_fn):
            suffix = rng.integers(0, 512, int(rng.integers(2, 14)))
            prompts[rid] = np.concatenate([system[f], suffix]).astype(
                np.int32)
            work.append(dict(req_id=rid, fn_id=f"fn{f}",
                             arrival=0.002 * rid, prompt_len=len(
                                 prompts[rid]),
                             output_len=int(rng.integers(2, 9)),
                             slo_ttft=100.0))
            rid += 1
    prompts[rid] = rng.integers(0, 512, 40).astype(np.int32)
    work.append(dict(req_id=rid, fn_id="fn0", arrival=0.003, prompt_len=40,
                     output_len=12, slo_ttft=100.0))      # too long
    rid += 1
    prompts[rid] = rng.integers(0, 512, 9).astype(np.int32)
    work.append(dict(req_id=rid, fn_id="fn_bad", arrival=0.004,
                     prompt_len=9, output_len=3, slo_ttft=100.0))
    fn_adapter = {f"fn{f}": f for f in range(n_fn)}
    fn_adapter["fn_bad"] = 5
    return work, prompts, fn_adapter


@pytest.mark.parametrize("num_blocks", [32, 9])   # ample pool / stalls
def test_replay_matches_reference_runtime(models, num_blocks):
    cfg_j, pj, pt = models
    work, prompts, fn_adapter = _trace()
    sink_j, sink_t = {}, {}
    rt_j = make_runtime(cfg_j, pj, num_blocks=num_blocks, timer=FakeTimer())
    res_j, _ = jax_replay_trace(rt_j, work, fn_adapter, prompts=prompts,
                                token_sink=sink_j)
    rt_t = _port_runtime(pt, num_blocks=num_blocks)
    res_t, _ = replay_trace(rt_t, work, fn_adapter, prompts=prompts,
                            token_sink=sink_t)

    def outcome(res):
        return [(r.req_id, r.first_token >= 0, sorted(r.breakdown))
                for r in res.requests
                if not set(r.breakdown) <= {"queue_wait", "prefill",
                                            "decode", "stalled_chunks"}
                or r.first_token < 0]

    assert outcome(res_t) == outcome(res_j)
    assert sink_t == sink_j
    admitted = {r.req_id for r in res_t.requests if r.first_token >= 0}
    assert len(admitted) == len(work) - 2
    for rt in (rt_t,):
        report = rt.check_invariants(res_t.requests)
        assert report["problems"] == []
        assert report["pool"]["live"] == 0 and report["slots_active"] == 0
    assert rt_t.stats["shared_block_maps"] == rt_j.stats["shared_block_maps"]
    assert rt_t.stats["shared_block_maps"] > 0
    assert rt_t.stats["stall_steps"] == rt_j.stats["stall_steps"]
    assert rt_t.stats["aborted"] == rt_j.stats["aborted"]
    assert torch.is_tensor(rt_t.cache[0]["kp"])
