"""Whole SMOKE model (Llama-2 family, float32) through the port against the
reference, with the reference's own parameters carried over by the weight
bridge; plus the sampling epilogue and the bridge itself.

Tolerance: logits within atol 1e-4 (two layers of float32 matmuls summed
in another order), greedy tokens equal.
"""
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
        ts.sampling_distribution(torch.from_numpy(logits), temp, top_k,
                                 top_p).numpy(),
        np.asarray(js.sampling_distribution(
            jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
            jnp.asarray(top_p))), atol=1e-6, rtol=1e-5)


def test_greedy_is_exact_first_index_argmax():
    logits = torch.tensor([[1.0, 3.0, 3.0, -1.0], [7.0, 7.0, 7.0, 7.0]])
    zeros = np.zeros(2, np.float32)
    got = ts.sample_tokens(logits, zeros, np.zeros(2, np.int32),
                           np.ones(2, np.float32), np.zeros(2, np.int32),
                           np.zeros(2, np.int32))
    assert got.tolist() == [1, 0] and got.dtype == torch.int32


def test_sampled_rows_are_counter_keyed_and_stay_in_the_kept_set():
    logits, temp, top_k, top_p = _sampling_case()
    lt = torch.from_numpy(logits)
    seed = np.arange(5, dtype=np.int32) + 11
    draws = [ts.sample_tokens(lt, temp, top_k, top_p, seed,
                              np.full(5, c, np.int32)).numpy()
             for c in range(40)]
    again = ts.sample_tokens(lt, temp, top_k, top_p, seed,
                             np.full(5, 7, np.int32)).numpy()
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
