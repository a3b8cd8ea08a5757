"""The port's artifact loading path (``repro_torch/serverless/loading.py``)
on the CPU, against ``tests/test_loading.py``'s reference.

``pipelined_device_put(device="cpu")`` runs the staging plan through
unpinned buffers, so every byte of every leaf is checked here; the pinned
path, the side stream and ``pin_host_tier`` run only on the card
(``chip_smoke.py`` phase 14).  Then the slice as a whole: a cold LoRA
function on SMOKE Llama in float32 — its backbone and adapter loaded,
the backbone registered in a ``BackboneStore``, a ``FunctionInstance``
opened, a batch formed by ``FunctionQueue`` — emits the reference's
greedy tokens on the same weights, and a second function reads the same
backbone tensors.

Exact comparisons throughout (copies bit for bit, the estimate's algebra
``==``), except the tokens, which hold the reference's greedy choices over
logits that agree within 1e-4 (``tests/test_torch_engine.py``).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten, _unflatten
from repro.configs import get_smoke as jax_get_smoke
from repro.core.engine import InferenceEngine as JaxEngine
from repro.models import transformer as jtf
from repro.serverless import latency as JL
from repro.serverless import loading as JLD
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.lora import _map, partition_lora, tree_leaves
from repro_torch.core.sharing import BackboneStore, FunctionInstance
from repro_torch.models import transformer as tf
from repro_torch.serverless import latency as L
from repro_torch.serverless import loading
from repro_torch.serverless.batching import (BatchProfile, FunctionQueue,
                                             Request)
from repro_torch.serverless.loading import (estimate_load_seconds,
                                            pipelined_device_put, stage_plan)


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.reshape(-1).view(torch.uint8).numpy()


@pytest.mark.parametrize("chunk_bytes", [64 << 20, 4096, 3])
def test_pipelined_device_put_roundtrip(monkeypatch, chunk_bytes):
    """A SMOKE Llama tree with its LoRA bank comes back bit for bit, a new
    tensor per leaf, None leaves kept, at the default chunk, a chunk that
    small leaves share and a 3-byte chunk that every leaf straddles."""
    monkeypatch.setattr(loading, "STAGE_CHUNK_BYTES", chunk_bytes)
    cfg = get_smoke("llama2_7b")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, "cpu", lora_adapters=4,
                            lora_b_scale=0.1)
    backbone, _ = partition_lora(params)
    for tree in (params, backbone):
        loaded, secs = pipelined_device_put(tree, device="cpu")
        assert secs >= 0.0
        src, got = tree_leaves(tree), tree_leaves(loaded)
        assert len(src) == len(got) > 0
        for a, b in zip(src, got):
            assert b.dtype == a.dtype and b.shape == a.shape
            assert b.data_ptr() != a.data_ptr()
            np.testing.assert_array_equal(_bits(a), _bits(b))
        assert _map(loaded, lambda x, _: x is None) == \
            _map(tree, lambda x, _: x is None)


def test_pipelined_device_put_refuses_unknown_device():
    with pytest.raises(ValueError):
        pipelined_device_put({"w": torch.ones(4)}, device="meta")


@pytest.mark.parametrize("hw", ["default", "h100"])
def test_overlap_estimate_equals_reference(hw):
    ours = {"default": L.DEFAULT_HW, "h100": L.H100_HW}[hw]
    ref = JL.Hardware(**dataclasses.asdict(ours))
    n = 14 * 2 ** 30
    got = {}
    for kw in (dict(from_remote=False), dict(from_remote=True, overlap=0.0),
               dict(from_remote=True, overlap=1.0),
               dict(from_remote=True, overlap=0.85)):
        got[str(kw)] = estimate_load_seconds(n, ours, **kw)
        assert got[str(kw)] == JLD.estimate_load_seconds(n, ref, **kw)
    h2d, full, piped, some = got.values()
    remote = n / ours.remote_bw
    assert h2d == pytest.approx(n / ours.h2d_bw)
    assert piped == pytest.approx(max(remote, h2d))
    assert full == pytest.approx(remote + h2d)
    assert piped <= some <= full


@pytest.mark.parametrize("sizes,chunk", [
    ([5, 20, 3, 0, 7], 8),         # straddling, one leaf over 2 chunks
    ([1, 1, 1, 1], 3),
    ([100], 7),                    # one leaf over 15 chunks
    ([0, 0], 4),                   # nothing to copy
    ([16, 16], 16),                # leaves on chunk boundaries
])
def test_stage_plan_covers_every_byte_once(sizes, chunk):
    plan = stage_plan(sizes, chunk)
    seen = [np.zeros(n, np.int64) for n in sizes]
    order = []
    for pieces in plan:
        assert 0 < sum(p[3] for p in pieces) <= chunk
        at = 0
        for i, off, buf_off, n in pieces:
            assert n > 0 and buf_off == at      # packed from the buffer's 0
            at += n
            seen[i][off:off + n] += 1
            order.append((i, off))
    assert all((s == 1).all() for s in seen)
    assert order == sorted(order)               # the leaves' bytes in order
    assert all(len(c) for c in plan[:-1])
    assert sum(sizes) == sum(p[3] for c in plan for p in c)
    if sum(sizes):
        assert len(plan) == -(-sum(sizes) // chunk)


def test_stage_plan_refuses_empty_chunk():
    with pytest.raises(ValueError):
        stage_plan([4], 0)


def test_h100_profile_differs_only_in_measured_and_datasheet_fields():
    """``H100_HW`` departs from ``SLICE_HW`` only where phase 14 measured
    it or the card's data sheet gives it; the rest are the stand-ins."""
    measured = {"h2d_bw", "runtime_init_s", "library_load_s",
                "kernel_compile_s"}
    datasheet = {"peak_flops", "hbm_bw", "hbm_bytes"}
    ours, ref = dataclasses.asdict(L.H100_HW), dataclasses.asdict(L.SLICE_HW)
    differ = {k for k in ours if ours[k] != ref[k]}
    assert differ <= measured | datasheet
    assert {"peak_flops", "hbm_bw", "hbm_bytes"} <= differ
    assert ours["hbm_bytes"] == 80 * 2 ** 30
    assert (ours["peak_flops"], ours["hbm_bw"]) == (989e12, 3.35e12)
    for k in ("remote_bw", "ici_bw", "container_init_s", "host_mem_bytes"):
        assert ours[k] == ref[k]


# ------------------------------------------------------ the slice as a whole
@pytest.fixture(scope="module")
def smoke_both():
    """SMOKE Llama, float32, a 4-adapter bank with nonzero LoRA B: the
    reference's tree and the port's, carried over by the weight bridge."""
    cfg_j = jax_get_smoke("llama2_7b").with_(dtype="float32")
    cfg_t = get_smoke("llama2_7b").with_(dtype="float32")
    flat = _flatten(jtf.init_params(jax.random.PRNGKey(0), cfg_j,
                                    lora_adapters=4))
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if "/lora/" in k and k.endswith("/b"):
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
    return (cfg_j, _unflatten(flat), cfg_t,
            params_from_flat(flat, cfg_t, device="cpu"))


def _one_adapter(params, i):
    """Adapter i of the stacked bank as a bank of one: the function's own
    ADAPTER artifact."""
    _, bank = partition_lora(params)
    return _map(bank, lambda x, _: None if x is None
                else x.narrow(-3, i, 1).contiguous())


@pytest.mark.parametrize("fn_adapter", [1, 3])
def test_cold_function_serves_reference_tokens(monkeypatch, smoke_both,
                                                fn_adapter):
    """Load the backbone and one adapter, register, open, batch, generate:
    the tokens equal the reference engine's on the full bank."""
    cfg_j, pj, cfg_t, pt = smoke_both
    monkeypatch.setattr(loading, "STAGE_CHUNK_BYTES", 1000)
    backbone, _ = partition_lora(pt)
    loaded_bb, _ = pipelined_device_put(backbone, device="cpu")
    loaded_ad, _ = pipelined_device_put(_one_adapter(pt, fn_adapter),
                                        device="cpu")
    store = BackboneStore()
    store.register("llama2-7b", cfg_t, loaded_bb)
    fn = FunctionInstance(f"fn{fn_adapter}", store.open("llama2-7b"),
                          loaded_ad, 0)
    q = FunctionQueue(fn.fn_id, BatchProfile(t0=0.1, alpha=0.02,
                                             max_batch=4))
    for i in range(5):
        q.push(Request(i, fn.fn_id, arrival=0.01 * i, prompt_len=16,
                       output_len=4, slo_ttft=2.5))
    batch = q.pop_batch()
    assert [r.req_id for r in batch] == [0, 1, 2, 3]
    toks = np.random.default_rng(1).integers(
        0, cfg_t.vocab_size, (len(batch), 16)).astype(np.int32)
    eng = InferenceEngine(cfg_t, fn.params, max_context=48, device="cpu")
    out, _ = eng.generate(torch.from_numpy(toks), 4,
                          adapter_idx=torch.zeros(len(batch),
                                                  dtype=torch.int32))
    ref, _ = JaxEngine(cfg_j, pj, max_context=48).generate(
        jnp.asarray(toks), 4,
        adapter_idx=jnp.full((len(batch),), fn_adapter, jnp.int32))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    # a second function on the same backbone: no backbone copy
    fn2 = FunctionInstance("fn0", store.open("llama2-7b"),
                           _one_adapter(pt, 0), 0)
    assert store.refcount("llama2-7b") == 2
    ptrs = [[t.data_ptr() for t in tree_leaves(partition_lora(f.params)[0])]
            for f in (fn, fn2)]
    assert ptrs[0] == ptrs[1] == [t.data_ptr() for t in
                                  tree_leaves(loaded_bb)]
    fn.close()
    fn2.close()
    assert store.refcount("llama2-7b") == 0
