"""Sampling as device data (``repro_torch/core/sampling.py``).

* ``philox_uniform_torch`` (torch ops on int64, 16-bit limbs) must equal
  the numpy ``philox_uniform`` bit for bit, at random seeds and counters
  and at 0, 2^31 - 1 and the int32 wrap.
* The branch-free ``sample_tokens`` (every row computes its greedy and its
  sampled token; all inputs tensors) must draw exactly what the host
  version it replaced drew — kept below as ``_host_sample_tokens`` — on
  all-greedy, all-sampled and mixed batches.
* ``keep_mask`` and ``sampling_distribution`` are held against ``repro``
  (the draws themselves cannot match its threefry keys).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as js
from repro_torch.core import sampling as ts

EDGES = np.array([0, 1, 2 ** 31 - 1, -2 ** 31, -1, 12345], np.int64)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_torch_philox_equals_numpy_bitwise(dtype):
    rng = np.random.default_rng(11)
    seed = rng.integers(-2 ** 31, 2 ** 31, 4096)
    counter = rng.integers(-2 ** 31, 2 ** 31, 4096)
    seed[:36] = np.repeat(EDGES, 6)
    counter[:36] = np.tile(EDGES, 6)
    seed, counter = seed.astype(dtype), counter.astype(dtype)
    want = ts.philox_uniform(seed, counter)
    got = ts.philox_uniform_torch(torch.from_numpy(seed),
                                  torch.from_numpy(counter)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_counter_wrap_matches_int32_arithmetic():
    """The decode dispatch adds the step to the counter in int64 and the
    draw reads 32-bit words: the same bits as an int32 counter that
    wraps."""
    seed = torch.tensor([7, 7], dtype=torch.int32)
    counter = torch.tensor([2 ** 31 - 1, -1], dtype=torch.int32)
    wide = ts.philox_uniform_torch(seed, counter.long() + 1)
    wrapped = np.array([-2 ** 31, 0], np.int32)   # int32 counter + 1
    np.testing.assert_array_equal(
        wide.numpy(), ts.philox_uniform(seed.numpy(), wrapped))


def _host_sample_tokens(logits, temperature, top_k, top_p, seed, counter):
    """The sampler as it was before sampling became device data: host
    numpy vectors, an all-greedy early return, a host Philox draw."""
    temperature = np.asarray(temperature, np.float32)
    greedy_tok = torch.argmax(logits, dim=-1).to(torch.int32)
    hot = temperature > 0.0
    if not hot.any():
        return greedy_tok
    t_safe = np.where(hot, temperature, 1.0).astype(np.float32)
    scaled = logits.float() / torch.as_tensor(t_safe)[:, None]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_scaled = torch.gather(scaled, -1, order)
    keep = ts.keep_mask(sorted_scaled, torch.as_tensor(top_k),
                        torch.as_tensor(top_p))
    masked = sorted_scaled.masked_fill(~keep, float("-inf"))
    cdf = torch.cumsum(torch.softmax(masked, dim=-1), dim=-1)
    u = torch.as_tensor(ts.philox_uniform(seed, counter))
    pos = torch.searchsorted(cdf, u[:, None], right=True)[:, 0]
    pos = torch.minimum(pos, keep.sum(dim=-1) - 1)
    sampled = torch.gather(order, -1, pos[:, None])[:, 0].to(torch.int32)
    return torch.where(torch.as_tensor(hot), sampled, greedy_tok)


def _batch(kind, B=16, V=300, seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    logits[0, 5] = logits[0, 9] = logits[0].max() + 1      # an argmax tie
    temp = rng.uniform(0.2, 2.0, B).astype(np.float32)
    if kind == "greedy":
        temp[:] = 0.0
    elif kind == "mixed":
        temp[::2] = 0.0
    top_k = rng.integers(-1, 40, B).astype(np.int32)
    top_p = rng.uniform(0.1, 1.0, B).astype(np.float32)
    top_p[::3] = 1.0
    seed = rng.integers(0, 2 ** 31, B).astype(np.int32)
    return logits, temp, top_k, top_p, seed


@pytest.mark.parametrize("kind", ["greedy", "sampled", "mixed"])
def test_branch_free_sampler_draws_what_the_host_sampler_drew(kind):
    logits, temp, top_k, top_p, seed = _batch(kind)
    lt = torch.from_numpy(logits)
    for c in (0, 1, 5, 2 ** 31 - 1):
        counter = np.full(seed.shape, c, np.int32)
        want = _host_sample_tokens(lt, temp, top_k, top_p, seed, counter)
        got = ts.sample_tokens(lt, *map(torch.from_numpy,
                                        (temp, top_k, top_p, seed,
                                         counter)))
        assert got.dtype == torch.int32
        assert torch.equal(got, want), (kind, c)
    if kind == "greedy":
        assert got.tolist()[0] == 5          # first index on ties


def test_keep_mask_and_distribution_match_reference():
    logits, temp, top_k, top_p, _ = _batch("mixed", B=12, V=64, seed=3)
    srt = -np.sort(-logits / np.where(temp > 0, temp, 1)[:, None], axis=-1)
    np.testing.assert_array_equal(
        ts.keep_mask(*map(torch.from_numpy, (srt, top_k, top_p))).numpy(),
        np.asarray(js.keep_mask(jnp.asarray(srt), jnp.asarray(top_k),
                                jnp.asarray(top_p))))
    np.testing.assert_allclose(
        ts.sampling_distribution(*map(torch.from_numpy,
                                      (logits, temp, top_k, top_p))).numpy(),
        np.asarray(js.sampling_distribution(
            jnp.asarray(logits), jnp.asarray(temp), jnp.asarray(top_k),
            jnp.asarray(top_p))), atol=1e-6, rtol=1e-5)
