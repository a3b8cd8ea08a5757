"""The new decoder configs of the zoo through the port's paged runtime,
and the leaves of the port's seeded ``init_params``, held against the
reference (``repro``) on the CPU.

The shared-prefix multi-adapter trace of ``test_torch_serving.py`` runs
through both packages' ``ContinuousRuntime`` on bridged SMOKE weights of
Qwen2.5-3B (QKV bias), Nemotron-4-340B (LayerNorm, squared ReLU, G = 4),
PaliGemma-3B (text-only, as the reference's runtime serves it) and
SmolLM-360M (G = 3): the greedy token streams must be equal.  Every bias
leaf is drawn nonzero, as in ``test_torch_zoo.py``.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest
import torch

from conftest import FakeTimer, build_model, make_runtime
from repro.checkpoint.store import _flatten, _unflatten
from repro.serving import replay_trace as jax_replay_trace
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import ARCH_IDS, get_smoke
from repro_torch.models import transformer as tf
from repro_torch.serving import ContinuousRuntime, ServingConfig, replay_trace

REPLAYED = ("qwen2_5_3b", "nemotron_4_340b", "paligemma_3b", "smollm_360m")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE-sized tensors: one intra-op thread (the test workers share the
    machine's cores); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, jax params, torch cfg, torch params): SMOKE in
    float32 with a 3-adapter bank, every bias leaf drawn nonzero."""
    out = {}
    for arch in REPLAYED:
        cfg_j, params = build_model(arch)
        flat = _flatten(params)
        rng = np.random.default_rng(0)
        for k, v in flat.items():
            if k.endswith("/b") or k.endswith("/bias"):
                flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    v.dtype)
        cfg_t = get_smoke(arch).with_(dtype="float32")
        out[arch] = (cfg_j, _unflatten(flat), cfg_t,
                     params_from_flat(flat, cfg_t, device="cpu"))
    return out


# ----------------------------------------------------------- paged replays
def _trace(vocab, seed=7, n_fn=3, per_fn=2):
    """Per-adapter 16-token system prompts and private suffixes."""
    rng = np.random.default_rng(seed)
    system = {f: rng.integers(0, vocab, 16).astype(np.int32)
              for f in range(n_fn)}
    work, prompts = [], {}
    rid = 0
    for i in range(per_fn):
        for f in range(n_fn):
            suffix = rng.integers(0, vocab, int(rng.integers(2, 14)))
            prompts[rid] = np.concatenate([system[f], suffix]).astype(
                np.int32)
            work.append(dict(req_id=rid, fn_id=f"fn{f}",
                             arrival=0.002 * rid,
                             prompt_len=len(prompts[rid]),
                             output_len=int(rng.integers(2, 9)),
                             slo_ttft=100.0))
            rid += 1
    return work, prompts, {f"fn{f}": f for f in range(n_fn)}


@pytest.mark.parametrize("arch", REPLAYED)
def test_replay_matches_reference_runtime(models, arch):
    """The shared-prefix multi-adapter trace through the paged runtime of
    both packages (PaliGemma text-only, as the reference's runtime serves
    it): the same greedy tokens, prefix sharing in both."""
    cfg_j, pj, cfg_t, pt = models[arch]
    work, prompts, fn_adapter = _trace(cfg_t.vocab_size)
    sink_j, sink_t = {}, {}
    rt_j = make_runtime(cfg_j, pj, timer=FakeTimer())
    jax_replay_trace(rt_j, work, fn_adapter, prompts=prompts,
                     token_sink=sink_j)
    scfg = ServingConfig(num_slots=4, block_size=8, num_blocks=32,
                         max_blocks_per_slot=6, prefill_chunk=16,
                         decode_chunk=4)
    rt_t = ContinuousRuntime(cfg_t, pt, scfg, device="cpu",
                             timer=FakeTimer())
    res_t, _ = replay_trace(rt_t, work, fn_adapter, prompts=prompts,
                            token_sink=sink_t)
    assert sink_t == sink_j and len(sink_t) == len(work)
    assert rt_t.stats["shared_block_maps"] == rt_j.stats["shared_block_maps"]
    assert rt_t.stats["shared_block_maps"] > 0
    assert rt_t.check_invariants(res_t.requests)["problems"] == []


# ------------------------------------------------------------ init_params
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_has_the_reference_leaves(arch):
    """The port's seeded ``init_params`` builds the leaves (and shapes) the
    bridge gives from the reference's tree: QKV ``b`` with ``qkv_bias``,
    LayerNorm ``bias``, the squared-ReLU MLP without ``wg``."""
    cfg_j, pj = build_model(arch, lora_adapters=2)
    bridged = params_from_flat(_flatten(pj), get_smoke(arch), device="cpu")
    gen = torch.Generator().manual_seed(0)
    own = tf.init_params(get_smoke(arch).with_(dtype="float32"), gen, "cpu",
                         lora_adapters=2)

    def shapes(tree, pre=""):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                out.update(shapes(v, f"{pre}/{k}"))
            return out
        if isinstance(tree, list):
            out = {}
            for i, v in enumerate(tree):
                out.update(shapes(v, f"{pre}/{i}"))
            return out
        return {pre: tuple(tree.shape)}

    assert shapes(own) == shapes(bridged)
