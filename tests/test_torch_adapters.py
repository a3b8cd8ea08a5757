"""The adapter lifecycle of the port (``repro_torch.serving.adapters``)
held against the reference's ``AdapterRegistry`` side by side.

Every scenario of ``tests/test_adapter_registry.py`` runs as one script
on both runtimes — the reference's ``ContinuousRuntime`` and the port's,
on the SMOKE config in float32 on the CPU, over weights crossed over
through ``checkpoint/bridge.py`` and adapters drawn once with numpy and
handed to both.  After each step the token streams, the three adapter
counters, ``rejected_unknown_adapter``, ``artifact_retries`` and
``pin_counts()`` must be equal, and every LoRA leaf of the port's bank
must keep its ``data_ptr()`` (the port writes the bank in place so that
captured CUDA graphs stay valid).  Token streams are greedy and must be
equal exactly.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import FakeTimer, build_model
from repro.checkpoint.store import _flatten, _unflatten
from repro.core.lora import partition_lora as jax_partition_lora
from repro.serving import AdapterRegistry as JaxRegistry
from repro.serving import CompileGuard as JaxGuard
from repro.serving import ContinuousRuntime as JaxRuntime
from repro.serving import ServeRequest as JaxRequest
from repro.serving import ServingConfig as JaxConfig
from repro.serving import replay_requests as jax_replay_requests
from repro.serving.faults import ArtifactLoadError as JaxArtifactLoadError
from repro.serving.kv_pool import BlockPool as JaxPool
from repro.serving.prefix import PrefixCache as JaxPrefix
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.core.lora import partition_lora, tree_leaves
from repro_torch.serving import (AdapterRegistry, ArtifactLoadError,
                                 BlockPool, CompileGuard, ContinuousRuntime,
                                 PrefixCache, ServeRequest, ServingConfig,
                                 replay_requests, retry_with_backoff)

CFG_T = get_smoke("llama2_7b").with_(dtype="float32")
BS = 8
SCFG = dict(num_slots=4, block_size=BS, num_blocks=32, max_blocks_per_slot=6,
            prefill_chunk=16, decode_chunk=4)
COUNTERS = ("adapter_loads", "adapter_swaps", "adapter_unloads",
            "rejected_unknown_adapter", "artifact_retries")


@pytest.fixture(scope="module")
def model():
    cfg_j, params = build_model("llama2_7b")
    flat = _flatten(params)
    return cfg_j, flat


def _lora_keys(flat):
    return sorted(k for k in flat if "/lora/" in k)


def _adapter_flat(flat, seed, rank=None):
    """One adapter's leaves in the reference's flat layout (the bank's
    adapter axis -3 removed), a AND b random (a zero b would make every
    token comparison vacuous); ``rank`` cuts the rank below the bank's."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in _lora_keys(flat):
        shape = list(flat[k].shape)
        del shape[-3]
        arr = (rng.standard_normal(shape) * 0.05).astype(np.float32)
        if rank is not None:
            arr = arr[..., :rank] if k.endswith("/a") else \
                arr[..., :rank, :]
        out[k] = arr
    return out


def _path_key(path):
    return "/".join(f"#{p.idx}" if hasattr(p, "idx") else str(p.key)
                    for p in path)


def _jax_tree(params_j, one):
    _, bank = jax_partition_lora(params_j)
    return jax.tree_util.tree_map_with_path(
        lambda path, x: None if x is None else jnp.asarray(
            one[_path_key(path)]), bank, is_leaf=lambda x: x is None)


def _like(bank, src):
    """``src`` (LoRA leaves only) laid out in ``bank``'s full structure,
    None off the LoRA leaves."""
    if isinstance(bank, dict):
        return {k: _like(v, src.get(k) if isinstance(src, dict) else None)
                for k, v in bank.items()}
    if isinstance(bank, list):
        return [_like(v, s) for v, s in zip(bank, src)]
    return None if bank is None else src


def _port_tree(params_t, one):
    lora_only = params_from_flat(one, CFG_T, device="cpu")
    return _like(partition_lora(params_t)[1], lora_only)


class Pair:
    """The reference and the port runtime over the same weights, each with
    an attached registry, driven step by step."""

    def __init__(self, flat, **scfg):
        self.cfg_j = build_model("llama2_7b")[0]
        self.pj = _unflatten(flat)
        self.pt = params_from_flat(flat, CFG_T, device="cpu")
        kw = {**SCFG, **scfg}
        # deterministic clocks: replays take the same scheduling decisions
        self.rj = JaxRuntime(self.cfg_j, self.pj, JaxConfig(**kw),
                             timer=FakeTimer())
        self.rt = ContinuousRuntime(CFG_T, self.pt, ServingConfig(**kw),
                                    device="cpu", timer=FakeTimer())
        self.gj = JaxRegistry(self.rj)
        self.gt = AdapterRegistry(self.rt)
        self.ptrs = self.bank_ptrs()

    def bank_ptrs(self):
        return [t.data_ptr() for t in tree_leaves(
            partition_lora(self.rt.params)[1])]

    def load(self, name, one):
        a = self.gj.load(name, _jax_tree(self.rj.params, one))
        b = self.gt.load(name, _port_tree(self.rt.params, one))
        assert a == b
        self.check()
        return b

    def swap(self, name, one):
        a = self.gj.swap(name, _jax_tree(self.rj.params, one))
        b = self.gt.swap(name, _port_tree(self.rt.params, one))
        assert a == b
        self.check()

    def unload(self, name):
        assert self.gj.unload(name) == self.gt.unload(name)
        self.check()

    def serve(self, items):
        """Admit [(prompt, adapter, out)] on both and run to completion;
        returns the per-item token lists (equal on both)."""
        got = [_serve(rt, cls, items) for rt, cls in
               ((self.rj, JaxRequest), (self.rt, ServeRequest))]
        assert got[0] == got[1]
        self.check()
        return got[1]

    def check(self):
        for c in COUNTERS:
            assert self.rt.stats[c] == self.rj.stats[c], c
        assert self.gt.pin_counts() == self.gj.pin_counts()
        assert self.gt.names() == self.gj.names()
        assert self.bank_ptrs() == self.ptrs          # written in place
        assert self.rt.check_invariants()["problems"] == []


def _serve(rt, cls, items):
    srs = [cls(prompt=p, adapter=a, max_new_tokens=o) for p, a, o in items]
    res = rt.try_admit(srs)
    assert res is not None and not res.rejected
    toks = {i: [res.first_tokens[i]] for i in range(len(items))}
    sid2i = {sid: i for i, sid in enumerate(res.slot_ids) if sid >= 0}
    while rt.slots.num_active:
        d = rt.decode()
        for sid, t in d.emitted.items():
            if sid in sid2i:
                toks[sid2i[sid]].extend(t)
    return [toks[i] for i in range(len(items))]


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, CFG_T.vocab_size, n,
                                                dtype=np.int32)


# ------------------------------------------------------------- lifecycle
def test_load_serve_unload_slot_reuse_roundtrip(model):
    cfg_j, flat = model
    p = Pair(flat)
    assert p.rt.adapters is p.gt and p.gt.capacity == 3
    prompt = _prompt(0, 12)
    assert p.load("summarize", _adapter_flat(flat, 1)) == 0
    assert p.load("translate", _adapter_flat(flat, 2)) == 1
    out_a = p.serve([(prompt, "summarize", 4)])[0]
    p.unload("summarize")
    assert p.gt.names() == ["translate"]
    assert p.load("classify", _adapter_flat(flat, 3)) == 0   # LIFO reuse
    out_c = p.serve([(prompt, "classify", 4)])[0]
    assert out_a != out_c
    for rt, cls in ((p.rj, JaxRequest), (p.rt, ServeRequest)):
        res = rt.try_admit([cls(prompt=prompt, adapter="summarize",
                                max_new_tokens=2)])
        assert len(res.rejected) == 1
        # an unloaded raw slot is refused too
        res = rt.try_admit([cls(prompt=prompt, adapter=2,
                                max_new_tokens=2)])
        assert len(res.rejected) == 1
    p.check()
    assert p.rt.stats["rejected_unknown_adapter"] == 2
    assert p.rt.stats["adapter_loads"] == 3
    assert p.rt.stats["adapter_unloads"] == 1
    assert p.rt.pool.in_use == 0 and p.rt.slots.num_active == 0


def test_unload_while_pinned_refused(model):
    cfg_j, flat = model
    p = Pair(flat)
    p.load("live", _adapter_flat(flat, 5))
    prompt = _prompt(1, 12)
    res = [rt.try_admit([cls(prompt=prompt, adapter="live",
                             max_new_tokens=8)])
           for rt, cls in ((p.rj, JaxRequest), (p.rt, ServeRequest))]
    assert res[0].first_tokens == res[1].first_tokens
    assert res[1].slot_ids[0] >= 0
    assert p.gt.pinned("live") == 1
    p.check()
    for reg in (p.gj, p.gt):
        with pytest.raises(RuntimeError, match="pin"):
            reg.unload("live")
    with pytest.raises(RuntimeError, match="pin"):
        p.gj.swap("live", _jax_tree(p.rj.params, _adapter_flat(flat, 6)))
    with pytest.raises(RuntimeError, match="pin"):
        p.gt.swap("live", _port_tree(p.rt.params, _adapter_flat(flat, 6)))
    p.check()
    for rt in (p.rj, p.rt):
        while rt.slots.num_active:
            rt.decode()
    assert p.gt.pinned("live") == 0                  # finish unpins
    p.unload("live")
    assert len(p.gt) == 0


def test_unload_purges_prefix_cache(model):
    cfg_j, flat = model
    p = Pair(flat)
    slot = p.load("fn", _adapter_flat(flat, 9))
    prompt = _prompt(2, 2 * BS)
    p.serve([(prompt, "fn", 2)])
    assert len(p.rt.prefix) == len(p.rj.prefix) > 0
    assert p.rt.pool.num_cached == p.rj.pool.num_cached > 0
    assert p.rt.prefix.covered_tokens(slot, prompt) == 2 * BS
    p.unload("fn")
    assert len(p.rt.prefix) == len(p.rj.prefix) == 0
    assert p.rt.pool.num_cached == p.rj.pool.num_cached == 0
    assert p.rt.prefix.covered_tokens(slot, prompt) == 0
    p.load("fn2", _adapter_flat(flat, 10))
    shared = p.rt.stats["shared_tokens"]
    p.serve([(prompt, "fn2", 2)])
    assert p.rt.stats["shared_tokens"] == p.rj.stats["shared_tokens"] \
        == shared


def _narrow_bank(params, slot):
    """The one-runtime-per-adapter oracle's params: the same backbone
    tensors and a bank of capacity 1 holding ``slot``."""
    def walk(t, in_lora=False):
        if isinstance(t, dict):
            return {k: walk(v, in_lora or k == "lora") for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, in_lora) for v in t]
        return t.narrow(-3, slot, 1) if in_lora else t
    return walk(params)


def test_adapter_churn_zero_recapture_and_per_adapter_oracle(model):
    """Mixed-adapter serving with load/swap/unload churn between
    dispatches: decode and prefill each capture EXACTLY once under the
    port's CompileGuard (the reference's compiles once under its own),
    and every request's tokens equal a one-runtime-per-adapter oracle's
    (an N=1 bank narrowed from the same post-churn bank)."""
    cfg_j, flat = model
    p = Pair(flat)
    p1, p2 = _prompt(3, 12), _prompt(4, 14)
    p.load("a", _adapter_flat(flat, 21))
    p.load("b", _adapter_flat(flat, 22))
    with JaxGuard({"decode": 1, "prefill": 1}, runtime=p.rj), \
            CompileGuard({"decode": 1, "prefill": 1},
                         runtime=p.rt) as guard:
        p.rj.warmup()
        p.rt.warmup()
        mixed = p.serve([(p1, "a", 6), (p2, "b", 6)])
        p.load("c", _adapter_flat(flat, 23))
        out_c = p.serve([(p1, "c", 6)])[0]
        p.swap("c", _adapter_flat(flat, 25, rank=CFG_T.lora.rank // 2))
        out_c2 = p.serve([(p1, "c", 6)])[0]
        p.unload("b")
        p.load("d", _adapter_flat(flat, 24))
        mixed2 = p.serve([(p1, "a", 6), (p2, "d", 6)])
    rep = guard.report()
    assert rep["decode_compiles"] == 1 and rep["prefill_compiles"] == 1
    assert p.rt.decode_compiles() == 1 and p.rt.prefill_compiles() == 1
    assert out_c != out_c2                 # the swap took effect
    for prompt, name, want in [(p1, "a", mixed[0]), (p2, "d", mixed2[1]),
                               (p1, "c", out_c2), (p1, "a", mixed2[0])]:
        single = ContinuousRuntime(
            CFG_T, _narrow_bank(p.rt.params, p.gt.slot_of(name)),
            p.rt.scfg, device="cpu")
        got = _serve(single, ServeRequest, [(prompt, 0, 6)])[0]
        assert got == want, f"{name}: mixed {want} != single-runtime {got}"
    assert mixed[0] != mixed[1]


def test_smaller_rank_adapter_is_zero_padded(model):
    """A rank-r/2 adapter loads into the rank-r bank as zero columns of A
    and zero rows of B, on both sides."""
    cfg_j, flat = model
    p = Pair(flat)
    r = CFG_T.lora.rank
    one = _adapter_flat(flat, 31, rank=r // 2)
    slot = p.load("small", one)
    a = p.rt.params["layers"][0]["attn"]["lora"]["q"]["a"][slot]
    b = p.rt.params["layers"][0]["attn"]["lora"]["q"]["b"][slot]
    assert torch.all(a[:, r // 2:] == 0) and torch.all(b[r // 2:] == 0)
    p.serve([(_prompt(5, 10), "small", 5)])
    too_big = _adapter_flat(flat, 32)
    key = _lora_keys(flat)[0]
    too_big[key] = np.concatenate([too_big[key]] * 2, axis=-1 if
                                  key.endswith("/a") else -2)
    with pytest.raises(ValueError, match="exceeds bank slot"):
        p.gt.load("big", _port_tree(p.rt.params, too_big))
    assert p.gt.names() == ["small"] and p.bank_ptrs() == p.ptrs


def test_replay_requests_by_name(model):
    """Names flow through ``replay_requests`` (fn_id = the name) as in the
    reference: the same admitted/rejected requests and token streams,
    with one request on a name the registry does not hold."""
    cfg_j, flat = model
    p = Pair(flat)
    p.load("alpha", _adapter_flat(flat, 50))
    p.load("beta", _adapter_flat(flat, 51))
    plan = [("alpha", 10, 4), ("beta", 17, 5), ("gone", 9, 3),
            ("alpha", 21, 2), (None, 12, 3), ("beta", 6, 6)]
    sinks = []
    for rt, cls, replay in ((p.rj, JaxRequest, jax_replay_requests),
                            (p.rt, ServeRequest, replay_requests)):
        sink = {}
        res, _ = replay(rt, [cls(prompt=_prompt(60 + i, n), adapter=a,
                                 arrival=0.001 * i, max_new_tokens=o)
                             for i, (a, n, o) in enumerate(plan)],
                        token_sink=sink)
        sinks.append((sink, sorted(r.req_id for r in res.requests
                                   if "rejected_unknown_adapter"
                                   in r.breakdown)))
    assert sinks[0] == sinks[1]
    assert sinks[1][1] == [2] and len(sinks[1][0]) == len(plan) - 1
    p.check()


# ------------------------------------------------- retry and rollback
def test_retry_with_backoff_bounds_and_sleeps():
    sleeps, calls, retried = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ArtifactLoadError("transient")
        return "ok"

    assert retry_with_backoff(flaky, retries=2, backoff_s=0.5,
                              sleep=sleeps.append,
                              on_retry=lambda a, e: retried.append(a)) == "ok"
    assert sleeps == [0.5, 1.0] and retried == [0, 1] and len(calls) == 3
    calls.clear()
    with pytest.raises(ArtifactLoadError):
        retry_with_backoff(flaky, retries=1, sleep=sleeps.append)
    assert len(calls) == 2
    with pytest.raises(ValueError):
        retry_with_backoff(flaky, retries=-1)
    with pytest.raises(KeyError):                 # not a transient error
        retry_with_backoff(lambda: {}["x"], retries=3)


def test_failed_load_rolls_back_after_retries(model, monkeypatch):
    """A store that fails every time: ``artifact_retries`` retries are
    counted, the final failure propagates, and the registry (and the
    bank) are exactly as before — the slot is free for the next load."""
    cfg_j, flat = model
    p = Pair(flat, artifact_retries=3)
    p.load("keep", _adapter_flat(flat, 40))
    before = [t.clone() for t in tree_leaves(
        partition_lora(p.rt.params)[1])]

    def boom(err):
        def store(*_a, **_k):
            raise err("injected")
        return store

    monkeypatch.setattr(p.gj, "_store", boom(JaxArtifactLoadError))
    monkeypatch.setattr(p.gt, "_store", boom(ArtifactLoadError))
    one = _adapter_flat(flat, 41)
    with pytest.raises(JaxArtifactLoadError):
        p.gj.load("new", _jax_tree(p.rj.params, one))
    with pytest.raises(ArtifactLoadError):
        p.gt.load("new", _port_tree(p.rt.params, one))
    p.check()
    assert p.rt.stats["artifact_retries"] == 3
    assert p.gt.names() == ["keep"] and p.gt.resolve("new") is None
    after = tree_leaves(partition_lora(p.rt.params)[1])
    assert all(torch.equal(x, y) for x, y in zip(before, after))
    monkeypatch.undo()
    assert p.load("new", one) == 1               # the slot came back


# ------------------------------------------------- purge helpers
def test_forget_adapter_matches_reference():
    rng = np.random.default_rng(6)
    tries = [JaxPrefix(4), PrefixCache(4)]
    pid = iter(range(1, 1000))
    for adapter in (0, 1, 0, 2, 1):
        toks = rng.integers(0, 9, 12).astype(np.int32)
        phys = [next(pid) for _ in range(3)]
        for pc in tries:
            shared, node = pc.match(adapter, toks)
            pc.register(adapter, toks, shared + phys[len(shared):],
                        len(shared), node)
    # a child under a shared first block
    for pc in tries:
        base = np.arange(12, dtype=np.int32)
        sh, node = pc.match(1, base[:4])
        pc.register(1, base, [900, 901, 902], len(sh), node)
    got = [sorted(pc.forget_adapter(1)) for pc in tries]
    assert got[0] == got[1] and got[0]
    assert [len(pc) for pc in tries] == [len(tries[0])] * 2
    assert [pc.forget_adapter(1) for pc in tries] == [[], []]
    left = [sorted(pc.forget_adapter(0)) for pc in tries]
    assert left[0] == left[1]


def test_drop_cached_matches_reference():
    pools = [JaxPool(num_blocks=10, block_size=4),
             BlockPool(num_blocks=10, block_size=4)]
    for pool in pools:
        pool.cache_hook = lambda b: b % 2 == 0
        ids = pool.alloc(6)
        pool.free(ids[:4])                       # evens park cached
        assert pool.num_cached == 2
    moved = [pool.drop_cached([ids[0], ids[1], ids[4], 99])
             for pool in pools]
    assert moved[0] == moved[1]
    assert [(p.num_cached, p.num_free, p.in_use) for p in pools][0] == \
        [(p.num_cached, p.num_free, p.in_use) for p in pools][1]
