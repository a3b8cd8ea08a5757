"""The port's warm-function ``InferenceEngine`` over ring caches on the CPU
(plain attention versions) against the reference's ``InferenceEngine``,
with the reference's own parameters carried over by the weight bridge.

Configs: the SMOKE Llama stack (G = 1), a GQA stack (4 query heads over
2 kv heads, as ``tests/test_lora_core.py::CFG`` has G > 1), SMOKE Llama
with a sliding window, and the MoE SMOKE stacks of Mixtral (16-token
window) and Grok.  LoRA B is drawn nonzero so every adapter's delta
is real.

Tolerances, float32: logits within atol = rtol = 1e-4 (layers of float32
matmuls summed in another order); ring caches (k, v) within 1e-4, slot
positions and ``idx`` equal; greedy tokens equal.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten, _unflatten
from repro.configs import get_smoke as jax_get_smoke
from repro.core.engine import InferenceEngine as JaxEngine
from repro.models import transformer as jtf
from repro.models.config import LoRAConfig as JaxLoRA
from repro.models.config import ModelConfig as JaxConfig
from repro_torch import kernels
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.core.engine import InferenceEngine
from repro_torch.models.config import LoRAConfig, ModelConfig

TOL = dict(atol=1e-4, rtol=1e-4)
ADAPTERS = np.array([0, 1, 2], np.int32)

_GQA = dict(name="gqa", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=96, dtype="float32")
CONFIGS = {
    "llama": (jax_get_smoke("llama2_7b").with_(dtype="float32"),
              get_smoke("llama2_7b").with_(dtype="float32")),
    "gqa": (JaxConfig(**_GQA, lora=JaxLoRA(rank=4, alpha=8.0,
                                           num_adapters=3)),
            ModelConfig(**_GQA, lora=LoRAConfig(rank=4, alpha=8.0,
                                                num_adapters=3))),
    "llama-window6": (
        jax_get_smoke("llama2_7b").with_(dtype="float32", sliding_window=6),
        get_smoke("llama2_7b").with_(dtype="float32", sliding_window=6)),
    # the MoE stacks (Mixtral with its 16-token window)
    "mixtral": (jax_get_smoke("mixtral_8x22b").with_(dtype="float32"),
                get_smoke("mixtral_8x22b").with_(dtype="float32")),
    "grok": (jax_get_smoke("grok_1_314b").with_(dtype="float32"),
             get_smoke("grok_1_314b").with_(dtype="float32")),
}


@pytest.fixture(scope="module")
def models():
    """name -> (jax cfg, jax params, torch cfg, torch params)."""
    out = {}
    for name, (cfg_j, cfg_t) in CONFIGS.items():
        params = jtf.init_params(jax.random.PRNGKey(0), cfg_j,
                                 lora_adapters=3)
        flat = _flatten(params)
        rng = np.random.default_rng(0)
        for k, v in flat.items():
            if "/lora/" in k and k.endswith("/b"):
                flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    v.dtype)
        out[name] = (cfg_j, _unflatten(flat), cfg_t,
                     params_from_flat(flat, cfg_t, device="cpu"))
    return out


def _engines(models, name, max_context):
    cfg_j, pj, cfg_t, pt = models[name]
    return (JaxEngine(cfg_j, pj, max_context=max_context),
            InferenceEngine(cfg_t, pt, max_context=max_context,
                            device="cpu"))


def _prompts(vocab, B=3, T=8, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)).astype(
        np.int32)


def _assert_caches_match(cache_t, cache_j):
    lay = cache_j["periods"]["p0"]
    assert len(cache_t) == lay["k"].shape[0]
    for i, c in enumerate(cache_t):
        for name in ("k", "v"):
            np.testing.assert_allclose(c[name].numpy(),
                                       np.asarray(lay[name][i]), **TOL)
        np.testing.assert_array_equal(c["slot_pos"].numpy(),
                                      np.asarray(lay["slot_pos"][i]))
        assert c["idx"] == int(lay["idx"][i])


@pytest.mark.parametrize("name", ["llama", "gqa"])
def test_prefill_logits_and_ring_cache_match_reference(models, name):
    ej, et = _engines(models, name, max_context=16)
    toks = _prompts(models[name][2].vocab_size)
    lj, cj = ej.prefill(jnp.asarray(toks), jnp.asarray(ADAPTERS))
    lt, ct = et.prefill(torch.from_numpy(toks), torch.from_numpy(ADAPTERS))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_caches_match(ct, cj)


@pytest.mark.parametrize("name,max_context,T,new", [
    ("llama", 32, 8, 8),
    ("gqa", 32, 8, 8),
    ("llama", 12, 8, 10),          # decodes past max_context: ring wraps
    ("gqa", 12, 8, 10),
])
def test_generate_matches_reference(models, name, max_context, T, new):
    ej, et = _engines(models, name, max_context)
    toks = _prompts(models[name][2].vocab_size, T=T, seed=2)
    out_j, cj = ej.generate(jnp.asarray(toks), new,
                            adapter_idx=jnp.asarray(ADAPTERS))
    kernels.reset_launches()
    out_t, ct = et.generate(torch.from_numpy(toks), new,
                            adapter_idx=torch.from_numpy(ADAPTERS))
    assert out_t.dtype == torch.int32 and out_t.shape == (3, new)
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    _assert_caches_match(ct, cj)
    # the CPU takes the plain versions: no kernel launched
    assert set(kernels.launch_counts().values()) == {0}
    if T + new - 1 > max_context:
        assert int(ct[0]["slot_pos"].min()) > 0      # slot 0 overwritten


@pytest.mark.parametrize("name,max_context,T", [
    ("llama", 8, 12),              # T > S: attend over all, keep last S
    ("llama-window6", 32, 10),     # ring = the 6-token window
])
def test_ring_overflow_prefill_then_decode_matches_reference(
        models, name, max_context, T):
    ej, et = _engines(models, name, max_context)
    toks = _prompts(models[name][2].vocab_size, T=T, seed=3)
    lj, cj = ej.prefill(jnp.asarray(toks), jnp.asarray(ADAPTERS))
    lt, ct = et.prefill(torch.from_numpy(toks), torch.from_numpy(ADAPTERS))
    S = ct[0]["k"].shape[1]
    assert S < T
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_caches_match(ct, cj)
    out_j, _ = ej.generate(jnp.asarray(toks), 5,
                           adapter_idx=jnp.asarray(ADAPTERS))
    out_t, _ = et.generate(torch.from_numpy(toks), 5,
                           adapter_idx=torch.from_numpy(ADAPTERS))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_prefill_into_a_used_cache_is_refused(models):
    _, et = _engines(models, "llama", max_context=16)
    toks = torch.from_numpy(_prompts(512))
    ai = torch.from_numpy(ADAPTERS)
    _, cache = et.prefill(toks, ai)
    snapshot = [{k: (v.clone() if isinstance(v, torch.Tensor) else v)
                 for k, v in c.items()} for c in cache]
    with pytest.raises(ValueError, match="fresh cache"):
        et.prefill(toks, ai, cache=cache)
    for c, s in zip(cache, snapshot):           # nothing was written
        assert c["idx"] == s["idx"]
        assert torch.equal(c["k"], s["k"])
        assert torch.equal(c["slot_pos"], s["slot_pos"])


def test_decode_one_matches_reference(models):
    ej, et = _engines(models, "gqa", max_context=16)
    toks = _prompts(96, seed=4)
    _, cj = ej.prefill(jnp.asarray(toks), jnp.asarray(ADAPTERS))
    _, ct = et.prefill(torch.from_numpy(toks), torch.from_numpy(ADAPTERS))
    nxt = np.array([5, 17, 90], np.int32)
    lj, cj = ej.decode_one(jnp.asarray(nxt), cj, jnp.asarray(8, jnp.int32),
                           jnp.asarray(ADAPTERS))
    lt, ct = et.decode_one(torch.from_numpy(nxt), ct,
                           torch.tensor(8, dtype=torch.int32),
                           torch.from_numpy(ADAPTERS))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_caches_match(ct, cj)


@pytest.mark.parametrize("B", [1, 3])
def test_prefill_adapter_ids_reach_sgmv_contiguous(models, B, monkeypatch):
    """The CUDA SGMV takes contiguous ids only, so the per-token ids a
    prefill expands from (B,) must be contiguous at every batch size (the
    expand of a single row is a stride-0 view until it is copied)."""
    from repro_torch.kernels.sgmv import ops
    seen, real = [], ops.sgmv_apply

    def spy(x, a, b, idx, **kw):
        seen.append(idx.is_contiguous())
        return real(x, a, b, idx, **kw)

    monkeypatch.setattr(ops, "sgmv_apply", spy)
    _, _, cfg_t, pt = models["llama"]
    eng = InferenceEngine(cfg_t, pt, max_context=16, device="cpu")
    out, _ = eng.generate(torch.from_numpy(_prompts(96, B=B)), 3,
                          torch.from_numpy(ADAPTERS[:B]))
    assert out.shape == (B, 3)
    assert seen and all(seen)


def test_ring_decode_refuses_a_position_off_the_ring_index(models):
    """Ring decode writes at slot ``pos % S`` (computed on the device so a
    captured step serves every position); the reference writes at
    ``idx % S``.  The two agree because decode runs at position ``idx``,
    and a host position that is not the ring's ``idx`` is refused."""
    _, _, cfg_t, pt = models["llama"]
    eng = InferenceEngine(cfg_t, pt, max_context=16, device="cpu")
    toks = torch.from_numpy(_prompts(96))
    ai = torch.from_numpy(ADAPTERS)
    _, cache = eng.prefill(toks, ai)
    nxt = torch.tensor([5, 17, 90], dtype=torch.int32)
    for pos in (7, 9, torch.tensor(9, dtype=torch.int32)):
        with pytest.raises(ValueError, match="has seen 8 tokens"):
            eng.decode_one(nxt, cache, pos, ai)
    assert cache[0]["idx"] == 8
    eng.decode_one(nxt, cache, 8, ai)
    assert cache[0]["idx"] == 9


@pytest.mark.parametrize("name,max_context,T,new", [
    ("mixtral", 32, 20, 8),        # prompt past the 16-token window
    ("mixtral", 24, 8, 12),        # decodes past the window: ring of 16
    ("grok", 32, 8, 8),
    ("grok", 12, 8, 10),           # ring wraps
])
def test_moe_prefill_and_generate_match_reference(models, name,
                                                  max_context, T, new):
    """The MoE stacks through the ring engine: prefill logits and ring
    caches, then greedy generation, equal to the reference's."""
    ej, et = _engines(models, name, max_context)
    toks = _prompts(models[name][2].vocab_size, T=T, seed=5)
    lj, cj = ej.prefill(jnp.asarray(toks), jnp.asarray(ADAPTERS))
    lt, ct = et.prefill(torch.from_numpy(toks), torch.from_numpy(ADAPTERS))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    _assert_caches_match(ct, cj)
    out_j, cj = ej.generate(jnp.asarray(toks), new,
                            adapter_idx=jnp.asarray(ADAPTERS))
    out_t, ct = et.generate(torch.from_numpy(toks), new,
                            adapter_idx=torch.from_numpy(ADAPTERS))
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    _assert_caches_match(ct, cj)


# ------------------------------------------------ slot-wise insert/extract
def _unstack(cfg, tree, key_map=lambda x: x):
    """The reference's {"periods", "tail"} cache tree -> one entry a layer
    (row n of periods/p{j} is layer n * len(pattern) + j)."""
    n_per = len(cfg.pattern)
    out = [None] * cfg.num_layers
    for pj, t in tree["periods"].items():
        j = int(pj[1:])
        for n in range(cfg.num_periods):
            out[n * n_per + j] = {k: key_map(np.asarray(v[n]))
                                  for k, v in t.items()}
    for i, t in enumerate(tree["tail"]):
        out[cfg.num_periods * n_per + i] = {
            k: key_map(np.asarray(v)) for k, v in t.items()}
    return out


def test_insert_extract_bitwise_equal_reference():
    """``make_insert_fn`` / ``make_extract_fn`` against the reference's on a
    SMOKE Llama pool of random contents, bit for bit: two rows of a
    prefilled ring (random K/V) into pool blocks, garbage ids (0) in both
    rows (so block 0 is written several times), the pool compared whole,
    then each row's blocks extracted."""
    from repro.core.engine import make_extract_fn as jextract
    from repro.core.engine import make_insert_fn as jinsert
    from repro.models.cache import init_cache as jinit_cache
    from repro.models.cache import init_paged_cache as jinit_paged
    from repro_torch.core.engine import make_extract_fn, make_insert_fn

    cfg_j, cfg_t = CONFIGS["llama"]
    G, nb, bs, NB = 2, 3, 4, 12
    rng = np.random.default_rng(3)

    def fill(tree):
        return jax.tree_util.tree_map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(
                np.float32)) if x.dtype == jnp.float32 else x, tree)

    pool_j = fill(jinit_paged(cfg_j, NB, bs))
    pre_j = fill(jinit_cache(cfg_j, G, nb * bs))
    ids = np.array([[5, 0, 7], [0, 2, 0]], np.int32)
    out_j = jax.jit(jinsert(cfg_j, bs))(pool_j, pre_j, jnp.asarray(ids))

    pool_t = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()}
              for layer in _unstack(cfg_j, pool_j)]
    pre_t = [{k: torch.from_numpy(v.copy()) for k, v in layer.items()
              if k in ("k", "v")} for layer in _unstack(cfg_j, pre_j)]
    out_t = make_insert_fn(cfg_t, bs)(pool_t, pre_t, torch.from_numpy(ids))
    assert out_t is pool_t                       # written in place
    for lt, lj in zip(out_t, _unstack(cfg_j, out_j)):
        for name in ("kp", "vp"):
            np.testing.assert_array_equal(lt[name].numpy(), lj[name])
    extract_t = make_extract_fn(cfg_t, bs)
    for row in range(G):
        ext_j = jax.jit(jextract(cfg_j, bs))(out_j, jnp.asarray(ids[row]))
        ext_t = extract_t(out_t, torch.from_numpy(ids[row]))
        for lt, lj in zip(ext_t, _unstack(cfg_j, ext_j)):
            for name in ("k", "v"):
                np.testing.assert_array_equal(lt[name].numpy(), lj[name])
        # a row of real (non-garbage) ids comes back as it went in
        for j in np.flatnonzero(ids[row]):
            sl = slice(j * bs, (j + 1) * bs)
            for lt, lp in zip(ext_t, pre_t):
                assert torch.equal(lt["k"][sl], lp["k"][row, sl])
