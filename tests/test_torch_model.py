"""Whole SMOKE model (Llama-2, and the MoE stacks of Mixtral and Grok,
float32) through the port against the reference, with the reference's own
parameters carried over by the weight bridge; plus the sampling epilogue
and the bridge itself.

Tolerance: logits within atol 1e-4 (two layers of float32 matmuls summed
in another order), greedy tokens equal.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_model
from repro.checkpoint.store import _flatten, _unflatten, save_checkpoint
from repro.configs import get_smoke as jax_get_smoke
from repro.core import sampling as js
from repro.core.engine import make_chunked_prefill_step as jax_prefill_step
from repro.core.engine import make_serve_step as jax_serve_step
from repro.models import transformer as jtf
from repro.models.cache import init_paged_cache as jax_init_cache
from repro_torch.checkpoint.bridge import load_params, params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.core import sampling as ts
from repro_torch.core.engine import make_chunked_prefill_step
from repro_torch.core.engine import make_serve_step
from repro_torch.models import transformer as tf
from repro_torch.models.cache import init_paged_cache

CFG_T = get_smoke("llama2_7b").with_(dtype="float32")


@pytest.fixture(scope="module")
def models():
    """Reference SMOKE params with nonzero LoRA B (the reference inits B
    at zero, which would hide the deltas), in both packages."""
    cfg_j, params = build_model("llama2_7b")
    flat = _flatten(params)
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if "/lora/" in k and k.endswith("/b"):
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
    return cfg_j, _unflatten(flat), params_from_flat(flat, CFG_T,
                                                     device="cpu")


def test_prefill_chunk_then_decode_matches_reference(models):
    cfg_j, pj, pt = models
    NB, bs, MB, C = 16, 8, 6, 16
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, CFG_T.vocab_size, (2, C)).astype(np.int32)
    tokens[0, 13:] = 0                          # row 0: 13-token prompt
    tbl = np.full((2, MB), -1, np.int32)
    tbl[0, :3] = [1, 2, 3]
    tbl[1, :3] = [5, 6, 7]
    ids = np.array([[1, 2], [5, 6]], np.int32)
    start = np.zeros(2, np.int32)
    last = np.array([12, 15], np.int32)
    ai = np.array([2, 1], np.int32)

    cache_j = jax_init_cache(cfg_j, NB, bs)
    lj, cache_j = jax_prefill_step(cfg_j)(
        pj, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(last),
        cache_j, jnp.asarray(ids), jnp.asarray(tbl),
        adapter_idx=jnp.asarray(ai), use_paged_kernel=True)
    cache_t = init_paged_cache(CFG_T, NB, bs, device="cpu")
    lt, cache_t = make_chunked_prefill_step(CFG_T)(
        pt, torch.from_numpy(tokens), torch.from_numpy(start),
        torch.from_numpy(last), cache_t, torch.from_numpy(ids),
        torch.from_numpy(tbl), adapter_idx=torch.from_numpy(ai))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                               rtol=1e-4)

    tok_j = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    tok_t = torch.argmax(lt, -1).to(torch.int32)
    np.testing.assert_array_equal(tok_t.numpy(), tok_j)
    pos = np.array([13, 16], np.int32)
    serve_j, serve_t = jax_serve_step(cfg_j), make_serve_step(CFG_T)
    for step in range(4):
        lj, cache_j = serve_j(pj, jnp.asarray(tok_j), cache_j,
                              jnp.asarray(pos + step),
                              adapter_idx=jnp.asarray(ai),
                              block_tbl=jnp.asarray(tbl),
                              use_paged_kernel=True)
        lt, cache_t = serve_t(pt, tok_t, cache_t,
                              torch.from_numpy(pos + step),
                              adapter_idx=torch.from_numpy(ai),
                              block_tbl=torch.from_numpy(tbl))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)
        tok_j = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        tok_t = torch.argmax(lt, -1).to(torch.int32)
        np.testing.assert_array_equal(tok_t.numpy(), tok_j)
    kp_j = np.asarray(cache_j["periods"]["p0"]["kp"])
    for i, layer in enumerate(cache_t):
        np.testing.assert_allclose(layer["kp"].numpy()[:, 1:],
                                   kp_j[i][:, 1:], atol=1e-4, rtol=1e-4)


def test_out_of_range_token_rejected_on_cpu(models):
    _, _, pt = models
    cache = init_paged_cache(CFG_T, 4, 8, device="cpu")
    with pytest.raises(ValueError, match="token ids"):
        make_serve_step(CFG_T)(
            pt, torch.tensor([CFG_T.vocab_size], dtype=torch.int32), cache,
            torch.zeros(1, dtype=torch.int32),
            adapter_idx=torch.zeros(1, dtype=torch.int32),
            block_tbl=torch.full((1, 2), -1, dtype=torch.int32))


# ------------------------------------------------------------- sampling
def _sampling_case():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((5, 50)).astype(np.float32) * 3
    temp = np.array([0.0, 0.7, 1.3, 1.0, 2.0], np.float32)
    top_k = np.array([0, 5, 0, 3, 50], np.int32)
    top_p = np.array([1.0, 1.0, 0.8, 0.6, 0.3], np.float32)
    return logits, temp, top_k, top_p


def test_keep_mask_and_distribution_match_reference():
    logits, temp, top_k, top_p = _sampling_case()
    srt = -np.sort(-logits / np.where(temp > 0, temp, 1)[:, None], axis=-1)
    np.testing.assert_array_equal(
        ts.keep_mask(torch.from_numpy(srt), torch.from_numpy(top_k),
                     torch.from_numpy(top_p)).numpy(),
        np.asarray(js.keep_mask(jnp.asarray(srt), jnp.asarray(top_k),
                                jnp.asarray(top_p))))
    np.testing.assert_allclose(
        ts.sampling_distribution(*map(torch.from_numpy,
                                      (logits, temp, top_k, top_p))).numpy(),
        np.asarray(js.sampling_distribution(
            jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
            jnp.asarray(top_p))), atol=1e-6, rtol=1e-5)


def test_greedy_is_exact_first_index_argmax():
    logits = torch.tensor([[1.0, 3.0, 3.0, -1.0], [7.0, 7.0, 7.0, 7.0]])
    zeros = torch.zeros(2)
    got = ts.sample_tokens(logits, zeros, torch.zeros(2, dtype=torch.int32),
                           torch.ones(2), torch.zeros(2, dtype=torch.int32),
                           torch.zeros(2, dtype=torch.int32))
    assert got.tolist() == [1, 0] and got.dtype == torch.int32


def test_sampled_rows_are_counter_keyed_and_stay_in_the_kept_set():
    lt, temp, top_k, top_p = map(torch.from_numpy, _sampling_case())
    seed = torch.arange(5, dtype=torch.int32) + 11
    draws = [ts.sample_tokens(lt, temp, top_k, top_p, seed,
                              torch.full((5,), c, dtype=torch.int32)).numpy()
             for c in range(40)]
    again = ts.sample_tokens(lt, temp, top_k, top_p, seed,
                             torch.full((5,), 7, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(again, draws[7])   # pure in (seed, ctr)
    dist = ts.sampling_distribution(lt, temp, top_k, top_p).numpy()
    for d in draws:
        assert np.all(dist[np.arange(5), d] > 0)
    assert len({tuple(d[1:]) for d in draws}) > 1    # counters move it
    u = ts.philox_uniform(np.arange(1000), np.arange(1000) * 3)
    assert u.dtype == np.float32 and 0.0 <= u.min() and u.max() < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.05


# --------------------------------------------------------------- bridge
def test_bridge_round_trips_a_bf16_checkpoint(tmp_path):
    cfg = get_smoke("llama2_7b")                   # bfloat16
    params = jtf.init_params(jax.random.PRNGKey(3), jax_get_smoke(
        "llama2_7b"), lora_adapters=2)
    path = str(tmp_path / "ck")
    save_checkpoint(path, params)
    got = load_params(path, cfg, device="cpu")
    flat = _flatten(params)
    assert got["embed"].dtype == torch.bfloat16
    assert len(got["layers"]) == cfg.num_layers
    for key, val in flat.items():
        if key.endswith("__empty_tuple__"):
            continue
        parts = key.split("/")
        want = np.asarray(val, np.float32)
        if parts[0] == "periods":
            for n in range(want.shape[0]):
                node = got["layers"][n]
                for p in parts[2:]:
                    node = node[p]
                assert node.dtype == torch.bfloat16
                np.testing.assert_array_equal(node.float().numpy(), want[n])
        else:
            node = got
            for p in parts:
                node = node[p]
            np.testing.assert_array_equal(node.float().numpy(), want)


# ------------------------------------------------------- MoE SMOKE configs
MOE_ARCHS = ["mixtral_8x22b", "grok_1_314b"]


@pytest.fixture(scope="module")
def moe_models():
    """arch -> (jax cfg, jax params, torch cfg, torch params): the MoE
    SMOKE stacks (Mixtral with its 16-token window) in float32, LoRA B
    nonzero."""
    out = {}
    for arch in MOE_ARCHS:
        cfg_j, params = build_model(arch)
        flat = _flatten(params)
        rng = np.random.default_rng(0)
        for k, v in flat.items():
            if "/lora/" in k and k.endswith("/b"):
                flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    v.dtype)
        cfg_t = get_smoke(arch).with_(dtype="float32")
        out[arch] = (cfg_j, _unflatten(flat), cfg_t,
                     params_from_flat(flat, cfg_t, device="cpu"))
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_paged_prefill_past_the_window_then_decode(moe_models, arch):
    """Three 16-token chunks of paged prefill (prompts of 40 and 48
    tokens, past Mixtral's 16-token window) and four decode steps, through
    the MoE MLP: logits within 1e-4 of the reference's and greedy tokens
    equal."""
    cfg_j, pj, cfg_t, pt = moe_models[arch]
    NB, bs, MB, C = 32, 8, 8, 16
    L = np.array([40, 48], np.int32)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg_t.vocab_size, (2, 48)).astype(np.int32)
    tbl = np.full((2, MB), -1, np.int32)
    tbl[0, :6] = np.arange(1, 7)
    tbl[1, :7] = np.arange(8, 15)
    ai = np.array([1, 2], np.int32)
    cache_j = jax_init_cache(cfg_j, NB, bs)
    cache_t = init_paged_cache(cfg_t, NB, bs, device="cpu")
    step_j, step_t = jax_prefill_step(cfg_j), make_chunked_prefill_step(
        cfg_t)
    for r in range(3):
        tokens = prompt[:, r * C:(r + 1) * C].copy()
        start = np.full(2, r * C, np.int32)
        last = np.minimum(L - 1 - r * C, C - 1).astype(np.int32)
        ids = tbl[:, 2 * r:2 * r + 2].copy()
        ids[ids < 0] = 0                          # past row 0's prompt
        lj, cache_j = step_j(
            pj, jnp.asarray(tokens), jnp.asarray(start), jnp.asarray(last),
            cache_j, jnp.asarray(ids), jnp.asarray(tbl),
            adapter_idx=jnp.asarray(ai), use_paged_kernel=True)
        lt, cache_t = step_t(
            pt, torch.from_numpy(tokens), torch.from_numpy(start),
            torch.from_numpy(last), cache_t, torch.from_numpy(ids),
            torch.from_numpy(tbl), adapter_idx=torch.from_numpy(ai))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)
    tok_j = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    tok_t = torch.argmax(lt, -1).to(torch.int32)
    np.testing.assert_array_equal(tok_t.numpy(), tok_j)
    serve_j, serve_t = jax_serve_step(cfg_j), make_serve_step(cfg_t)
    for step in range(4):
        lj, cache_j = serve_j(pj, jnp.asarray(tok_j), cache_j,
                              jnp.asarray(L + step),
                              adapter_idx=jnp.asarray(ai),
                              block_tbl=jnp.asarray(tbl),
                              use_paged_kernel=True)
        lt, cache_t = serve_t(pt, tok_t, cache_t,
                              torch.from_numpy(L + step),
                              adapter_idx=torch.from_numpy(ai),
                              block_tbl=torch.from_numpy(tbl))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4,
                                   rtol=1e-4)
        tok_j = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        tok_t = torch.argmax(lt, -1).to(torch.int32)
        np.testing.assert_array_equal(tok_t.numpy(), tok_j)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_round_trips_a_moe_checkpoint(arch, tmp_path):
    """The reference's save_checkpoint layout of a MoE stack (stacked
    ``periods/p0/moe/{router/w,wi,wg,wo}``) comes across leaf for leaf in
    bfloat16, and ``init_params`` draws the same tree."""
    cfg = get_smoke(arch)                          # bfloat16
    params = jtf.init_params(jax.random.PRNGKey(4), jax_get_smoke(arch),
                             lora_adapters=2)
    path = str(tmp_path / "ck")
    save_checkpoint(path, params)
    got = load_params(path, cfg, device="cpu")
    flat = _flatten(params)
    moe_keys = [k for k in flat if "/moe/" in k]
    assert sorted(k.split("/moe/")[1] for k in moe_keys) == \
        ["router/w", "wg", "wi", "wo"]
    for key in moe_keys:
        want = np.asarray(flat[key], np.float32)
        for n in range(cfg.num_layers):
            node = got["layers"][n]
            for p in key.split("/")[2:]:
                node = node[p]
            assert node.dtype == torch.bfloat16
            np.testing.assert_array_equal(node.float().numpy(), want[n])
    gen = torch.Generator()
    gen.manual_seed(0)
    drawn = tf.init_params(cfg, gen, "cpu", lora_adapters=2)

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)

    assert shapes(drawn) == shapes(got)
