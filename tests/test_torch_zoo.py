"""The rest of the decoder zoo in the port, held against the reference
(``repro``) on the CPU with the same numpy inputs and bridged weights:
Llama-2-13B, Nemotron-4-340B (LayerNorm, squared-ReLU MLP), Phi-3-medium,
Qwen2.5-3B (QKV bias), SmolLM-360M and PaliGemma-3B (the prefix-LM mask
over an image prefix of embeddings).  The paged runtime's replays of the
new configs and the leaves of the port's own ``init_params`` are in
``test_torch_zoo_serving.py``.

Every bias leaf of the bridged SMOKE checkpoints (QKV ``b``, LayerNorm
``bias``, LoRA B) is drawn nonzero, where the reference initialises it to
zero, so each one shows in the logits.

Tolerances: float32 logits within atol = rtol = 1e-4 of the reference's
(the two frameworks contract and reduce in other orders); the layers in
float32 within 1e-5 x max(1, max |reference|) and in bfloat16 within
2^-7 x that (one rounding of a float32 intermediate may fall either way);
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_model
from repro.checkpoint.store import _flatten, _unflatten, save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.models import cache as jax_cache
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro_torch.checkpoint.bridge import load_params, params_from_flat
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.engine import make_prefill_step
from repro_torch.kernels.flash_attention.ref import flash_ref
from repro_torch.models import layers
from repro_torch.models import transformer as tf

NEW = ("phi3_medium_14b", "qwen2_5_3b", "nemotron_4_340b", "smollm_360m",
       "paligemma_3b", "llama2_13b")
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE-sized tensors: one intra-op thread (the test workers share the
    machine's cores); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """A jax or numpy array as a torch tensor (bfloat16 through its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _close(got, want, tol, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > " \
                               f"{tol * scale:.3e}"


def _bias_leaf(key: str) -> bool:
    return key.endswith("/b") or key.endswith("/bias") or key == "bias"


@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, jax params, torch cfg, torch params): SMOKE in
    float32 with a 3-adapter bank, every bias leaf drawn nonzero."""
    out = {}
    for arch in NEW:
        cfg_j, params = build_model(arch)
        flat = _flatten(params)
        rng = np.random.default_rng(0)
        for k, v in flat.items():
            if _bias_leaf(k):
                flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    v.dtype)
        cfg_t = get_smoke(arch).with_(dtype="float32")
        out[arch] = (cfg_j, _unflatten(flat), cfg_t,
                     params_from_flat(flat, cfg_t, device="cpu"))
    return out


# ----------------------------------------------------------------- configs
def test_arch_ids_are_every_decoder_config_in_the_reference_order():
    from repro.configs import ARCH_IDS as JAX_IDS
    assert ARCH_IDS == JAX_IDS
    for arch in ARCH_IDS:
        assert get_config(arch) == _same_fields(jax_get_config(arch))
        assert get_smoke(arch) == _same_fields(jax_get_smoke(arch))


def _same_fields(cfg_j):
    """The reference config re-made as the port's dataclass."""
    from dataclasses import asdict
    from repro_torch.models.config import LoRAConfig, ModelConfig
    d = asdict(cfg_j)
    d["lora"] = LoRAConfig(**d["lora"])
    return ModelConfig(**d)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_count_matches_reference(arch):
    for full in (True, False):
        get_j = jax_get_config if full else jax_get_smoke
        get_t = get_config if full else get_smoke
        assert get_t(arch).param_count() == get_j(arch).param_count()
        assert get_t(arch).active_param_count() == \
            get_j(arch).active_param_count()


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    rng = np.random.default_rng(1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    x = jnp.asarray(rng.standard_normal((3, 5, 48)) * 2 + 0.5, jdt)
    p = {"scale": jnp.asarray(rng.standard_normal(48), jdt),
         "bias": jnp.asarray(rng.standard_normal(48), jdt)}
    want = jax_layers.apply_norm(x, p, "layernorm")
    got = layers.apply_norm(_t(x), {k: _t(v) for k, v in p.items()},
                            "layernorm")
    assert got.dtype == _t(want).dtype
    _close(got, want, 1e-5 if dtype == "float32" else 2.0 ** -7,
           "layernorm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_squared_relu_mlp_matches_reference(dtype):
    cfg_j = jax_get_smoke("nemotron_4_340b").with_(dtype=dtype)
    cfg_t = get_smoke("nemotron_4_340b").with_(dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rng = np.random.default_rng(2)
    D, F = cfg_t.d_model, cfg_t.d_ff
    x = jnp.asarray(rng.standard_normal((2, 7, D)), jdt)
    p = {"wi": {"w": jnp.asarray(rng.standard_normal((D, F)) / np.sqrt(D),
                                 jdt)},
         "wo": {"w": jnp.asarray(rng.standard_normal((F, D)) / np.sqrt(F),
                                 jdt)}}
    want = jax_layers.apply_mlp(p, cfg_j, x)
    got = layers.apply_mlp({k: {"w": _t(v["w"])} for k, v in p.items()},
                           cfg_t, _t(x))
    _close(got, want, 1e-5 if dtype == "float32" else 2.0 ** -7, "sqrelu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_with_qkv_bias_and_lora_bank_matches_reference(dtype):
    """``dense`` adds ``b`` before the per-row LoRA delta, as the
    reference does."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rng = np.random.default_rng(3)
    D, O, r, N = 32, 24, 4, 3
    x = jnp.asarray(rng.standard_normal((2, 5, D)), jdt)
    p = {"w": jnp.asarray(rng.standard_normal((D, O)) / np.sqrt(D), jdt),
         "b": jnp.asarray(rng.standard_normal(O), jdt)}
    lora = {"a": jnp.asarray(rng.standard_normal((N, D, r)) / np.sqrt(D),
                             jdt),
            "b": jnp.asarray(rng.standard_normal((N, r, O)) * 0.1, jdt)}
    ai = np.array([2, 0], np.int32)
    want = jax_layers.dense(x, p, lora, scaling=2.0,
                            adapter_idx=jnp.asarray(ai))
    ai_tok = np.repeat(ai, 5)
    got = layers.dense(_t(x), {k: _t(v) for k, v in p.items()},
                       {k: _t(v) for k, v in lora.items()}, scaling=2.0,
                       adapter_idx=_t(ai_tok))
    _close(got, want, 1e-5 if dtype == "float32" else 2.0 ** -6, "dense")


def test_prefix_mask_bidirectional_over_prefix():
    """The cases of the reference's test_models.py, read from the port's
    plain flash version: equal scores and one-hot values make query i's
    output the uniform average over exactly the keys it sees."""
    T, P = 6, 3
    q = torch.zeros(1, 1, T, T)
    kv = torch.eye(T)[None, None]
    out = flash_ref(q, torch.zeros(1, 1, T, T), kv, causal=True,
                    prefix_len=P)[0, 0]
    sees = out > 0
    assert sees[0, 2]                 # prefix token sees later prefix token
    assert not sees[4, 5]             # causal outside prefix
    assert sees[5, 1]
    pos = jnp.arange(T)[None]
    ref = np.asarray(jax_layers._scores_mask(pos, pos, "prefix", None,
                                             prefix_len=P)[0]) == 0.0
    assert (sees.numpy() == ref).all()
    # with a window the prefix rule comes first, the window after it
    out = flash_ref(q, torch.zeros(1, 1, T, T), kv, causal=True, window=2,
                    prefix_len=P)[0, 0]
    ref = np.asarray(jax_layers._scores_mask(pos, pos, "prefix", 2,
                                             prefix_len=P)[0]) == 0.0
    assert ((out > 0).numpy() == ref).all()


# --------------------------------------------------------------- the stacks
def _ring_run(cfg_j, pj, cfg_t, pt, toks, steps, embeds=None, ai=None):
    """Prefill on a fresh ring and ``steps`` greedy decode steps in both
    packages; returns the prefill logits and each step's logits."""
    B, T = toks.shape
    P = 0 if embeds is None else embeds.shape[1]
    ctx = P + T + steps + 3
    cj = jax_cache.init_cache(cfg_j, B, ctx)
    ct = tf.init_cache(cfg_t, B, ctx, device="cpu")
    kw_j = {} if ai is None else {"adapter_idx": jnp.asarray(ai)}
    kw_t = {} if ai is None else {"adapter_idx": _t(ai)}
    ej = None if embeds is None else jnp.asarray(embeds)
    et = None if embeds is None else _t(embeds)
    lj, cj, _ = jax_tf.forward(pj, cfg_j, jnp.asarray(toks), embeds=ej,
                               cache=cj, **kw_j)
    lt, ct = tf.forward(pt, cfg_t, _t(toks), embeds=et, cache=ct, **kw_t)
    out = [(lt, lj)]
    tok = np.asarray(lj)[:, -1].argmax(-1).astype(np.int32)
    for i in range(steps):
        dj, cj = jax_tf.decode_step(pj, cfg_j, jnp.asarray(tok), cj,
                                    jnp.asarray(P + T + i, jnp.int32),
                                    **kw_j)
        dt, ct = tf.decode_step(pt, cfg_t, _t(tok), ct, P + T + i, **kw_t)
        out.append((dt, dj))
        tok = np.asarray(dj).argmax(-1).astype(np.int32)
    return out


@pytest.mark.parametrize("arch", NEW)
def test_ring_forward_and_decode_match_reference(models, arch):
    """Prefill of 11 tokens on a ring and 4 decode steps, two rows on two
    adapters: every logit within 1e-4 of the reference's."""
    cfg_j, pj, cfg_t, pt = models[arch]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg_t.vocab_size, (2, 11)).astype(np.int32)
    runs = _ring_run(cfg_j, pj, cfg_t, pt, toks, 4,
                     ai=np.array([1, 2], np.int32))
    for i, (got, want) in enumerate(runs):
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL,
                                   err_msg=f"{arch} step {i}")


@pytest.mark.parametrize("P,T", [(8, 5), (13, 6)])
def test_prefix_forward_matches_reference(models, P, T):
    """PaliGemma SMOKE behind P random patch embeddings (the reference's
    stub frontend; 8 is its SMOKE ``num_image_tokens``): the T text logits
    and 3 decode steps after them."""
    cfg_j, pj, cfg_t, pt = models["paligemma_3b"]
    rng = np.random.default_rng(P)
    toks = rng.integers(0, cfg_t.vocab_size, (2, T)).astype(np.int32)
    embeds = rng.standard_normal((2, P, cfg_t.d_model)).astype(np.float32)
    runs = _ring_run(cfg_j, pj, cfg_t, pt, toks, 3, embeds=embeds,
                     ai=np.array([0, 2], np.int32))
    assert tuple(runs[0][0].shape) == (2, T, cfg_t.vocab_size)
    for i, (got, want) in enumerate(runs):
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL,
                                   err_msg=f"step {i}")


def test_prefill_step_with_embeds_matches_reference(models):
    """``make_prefill_step(embeds=)``: the last position's logits, as the
    reference's step returns them."""
    from repro.core.engine import make_prefill_step as jax_prefill_step
    cfg_j, pj, cfg_t, pt = models["paligemma_3b"]
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg_t.vocab_size, (3, 7)).astype(np.int32)
    embeds = rng.standard_normal((3, 8, cfg_t.d_model)).astype(np.float32)
    ai = np.array([0, 2, 1], np.int32)
    lj, _ = jax_prefill_step(cfg_j)(pj, jnp.asarray(toks),
                                    jax_cache.init_cache(cfg_j, 3, 20),
                                    embeds=jnp.asarray(embeds),
                                    adapter_idx=jnp.asarray(ai))
    lt, cache = make_prefill_step(cfg_t)(
        pt, _t(toks), tf.init_cache(cfg_t, 3, 20, device="cpu"),
        embeds=_t(embeds), adapter_idx=_t(ai))
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **LOGIT_TOL)
    assert cache[0]["idx"] == 15
    assert cache[0]["slot_pos"][:15].tolist() == list(range(15))


def test_embeds_are_refused_on_the_paged_pools(models):
    from repro_torch.models.cache import init_paged_cache
    _, _, cfg_t, pt = models["paligemma_3b"]
    cache = init_paged_cache(cfg_t, 8, 8, device="cpu")
    with pytest.raises(ValueError, match="ring caches only"):
        tf.forward(pt, cfg_t, torch.zeros((1, 8), dtype=torch.int32),
                   cache=cache, embeds=torch.zeros((1, 8, cfg_t.d_model)),
                   start_pos=torch.zeros(1, dtype=torch.int32))


# ------------------------------------------------------------------ bridge
def test_bias_leaves_cross_the_bridge(tmp_path):
    """A saved Nemotron SMOKE checkpoint (LayerNorm ``bias``) and a Qwen
    SMOKE one (QKV ``b``), bf16, with every bias drawn nonzero: the port's
    params hold the same values, leaf for leaf."""
    for arch, want_leaves in (("nemotron_4_340b", ("norm1/bias",
                                                   "norm2/bias")),
                              ("qwen2_5_3b", ("attn/wq/b", "attn/wk/b",
                                              "attn/wv/b"))):
        cfg = jax_get_smoke(arch)
        params = jax_tf.init_params(jax.random.PRNGKey(0), cfg,
                                    lora_adapters=2)
        flat = _flatten(params)
        rng = np.random.default_rng(1)
        for k, v in flat.items():
            if _bias_leaf(k):
                flat[k] = jnp.asarray(rng.standard_normal(v.shape),
                                      v.dtype)
        path = str(tmp_path / arch)
        save_checkpoint(path, _unflatten(flat))
        got = load_params(path, get_smoke(arch), device="cpu",
                          dtype=torch.bfloat16)
        L = cfg.num_layers
        for leaf in want_leaves:
            key = "periods/p0/" + leaf
            for n in range(L):
                t = got["layers"][n]
                for part in leaf.split("/"):
                    t = t[part]
                assert t.dtype == torch.bfloat16
                assert torch.equal(t, _t(flat[key][n]))
        if arch == "nemotron_4_340b":
            assert torch.equal(got["final_norm"]["bias"],
                               _t(flat["final_norm/bias"]))
