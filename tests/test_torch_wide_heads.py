"""The attention wrappers at the widest heads of the decoder zoo, on the
CPU (their plain versions) against the reference's Pallas kernels in
interpret mode, on the same numpy inputs: Nemotron-4-340B's head dim 192
with G = 12 query heads per kv head, PaliGemma-3B's 256 with G = 8 and
RecurrentGemma-9B's 256 with G = 16 (and its window); and the flash plain
version's prefix-LM bound against the reference model's ``attention_core``
under the ``"prefix"`` mask.

Also the wrappers' contracts: each kernel takes hd 32, 64, 128, 192 and
256; flash takes any G and ring decode, like paged decode, up to 16.

Tolerances: float32, atol = rtol = 1e-5 (the implementations differ only
in summation order); every compared row keeps at least one key.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_gqa as jax_decode_gqa
from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha
from repro.kernels.paged_attention.ops import \
    paged_decode_gqa as jax_paged_decode
from repro.kernels.paged_prefill.ops import \
    paged_prefill_gqa as jax_paged_prefill
from repro.models.layers import _scores_mask, attention_core
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ops import decode_gqa
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ops import paged_decode_gqa
from repro_torch.kernels.paged_prefill import ops as pp_ops
from repro_torch.kernels.paged_prefill.ops import paged_prefill_gqa

TOL = dict(atol=1e-5, rtol=1e-5)
SHAPES = [
    # K, G, hd, window
    pytest.param(1, 12, 192, None, id="nemotron-hd192-G12"),
    pytest.param(1, 8, 256, None, id="paligemma-hd256-G8"),
    pytest.param(1, 16, 256, 24, id="recurrentgemma-hd256-G16-window24"),
]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("K,G,hd,window", SHAPES)
def test_flash_at_wide_heads_matches_pallas(K, G, hd, window):
    rng = np.random.default_rng(hd + G)
    B, T = 1, 48
    q, k, v = (_randn(rng, B, T, K * G, hd), _randn(rng, B, T, K, hd),
               _randn(rng, B, T, K, hd))
    got = flash_mha(_t(q), _t(k), _t(v), causal=True, window=window)
    pallas = jax_flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, window=window, q_block=16,
                           kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("K,G,hd,window", SHAPES)
def test_ring_decode_at_wide_heads_matches_pallas(K, G, hd, window):
    rng = np.random.default_rng(hd + G + 1)
    B, S, written = 2, 40, 57                       # a wrapped ring
    q, k, v = (_randn(rng, B, K * G, hd), _randn(rng, B, S, K, hd),
               _randn(rng, B, S, K, hd))
    sp = np.full(S, -1, np.int32)
    for p in range(written):
        sp[p % S] = p
    got = decode_gqa(_t(q), _t(k), _t(v), _t(sp), written - 1,
                     window=window)
    pallas = jax_decode_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(sp), jnp.asarray(written - 1,
                                                         jnp.int32),
                            window=window, s_block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


def _pool(rng, K, hd, bs, B, MB):
    NB = 1 + B * MB
    kp, vp = _randn(rng, K, NB, bs, hd), _randn(rng, K, NB, bs, hd)
    tbl = (1 + rng.permutation(B * MB)).reshape(B, MB).astype(np.int32)
    return kp, vp, tbl


@pytest.mark.parametrize("K,G,hd,window", SHAPES)
def test_paged_decode_at_wide_heads_matches_pallas(K, G, hd, window):
    rng = np.random.default_rng(hd + G + 2)
    B, bs, MB = 2, 8, 5
    kp, vp, tbl = _pool(rng, K, hd, bs, B, MB)
    tbl[1, 4] = -1                                   # a hole past pos
    q = _randn(rng, B, K * G, hd)
    pos = np.array([37, 29], np.int32)
    got = paged_decode_gqa(_t(q), _t(kp), _t(vp), _t(tbl), _t(pos),
                           window=window)
    pallas = jax_paged_decode(jnp.asarray(q), jnp.asarray(kp),
                              jnp.asarray(vp), jnp.asarray(tbl),
                              jnp.asarray(pos), window=window,
                              interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


@pytest.mark.parametrize("K,G,hd,window", SHAPES)
def test_paged_prefill_at_wide_heads_matches_pallas(K, G, hd, window):
    rng = np.random.default_rng(hd + G + 3)
    B, bs, MB, C = 2, 8, 5, 16
    kp, vp, tbl = _pool(rng, K, hd, bs, B, MB)
    q = _randn(rng, B, C, K * G, hd)
    q_pos = (np.array([8, 24], np.int32)[:, None]
             + np.arange(C, dtype=np.int32)[None])
    got = paged_prefill_gqa(_t(q), _t(kp), _t(vp), _t(tbl), _t(q_pos),
                            window=window)
    pallas = jax_paged_prefill(jnp.asarray(q), jnp.asarray(kp),
                               jnp.asarray(vp), jnp.asarray(tbl),
                               jnp.asarray(q_pos), window=window,
                               interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)


PREFIX_CASES = [
    # B, T, K, G, hd, prefix_len, window
    pytest.param(2, 40, 1, 4, 32, 16, None, id="prefix16"),
    pytest.param(1, 70, 2, 2, 64, 37, None, id="prefix37-not-a-tile"),
    pytest.param(1, 50, 1, 8, 256, 20, 12, id="prefix20-window12-hd256"),
    pytest.param(1, 30, 1, 2, 32, 30, None, id="all-prefix-bidirectional"),
]


@pytest.mark.parametrize("B,T,K,G,hd,P,window", PREFIX_CASES)
def test_flash_prefix_matches_reference_prefix_mask(B, T, K, G, hd, P,
                                                    window):
    """The reference model's prefix-LM attention: ``_scores_mask`` kind
    "prefix" through ``attention_core``, the function the flash kernel's
    ``prefix_len`` bound stands for."""
    rng = np.random.default_rng(T + P)
    q, k, v = (_randn(rng, B, T, K * G, hd), _randn(rng, B, T, K, hd),
               _randn(rng, B, T, K, hd))
    got = flash_mha(_t(q), _t(k), _t(v), causal=True, window=window,
                    prefix_len=P)
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    mask = _scores_mask(pos, pos, "prefix", window, prefix_len=P)
    want = attention_core(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if P == T and window is None:                   # wholly bidirectional
        bidir = flash_mha(_t(q), _t(k), _t(v), causal=False)
        np.testing.assert_allclose(got.numpy(), bidir.numpy(), **TOL)


def test_flash_rejects_a_negative_prefix():
    q = torch.zeros((1, 4, 2, 32))
    k = torch.zeros((1, 4, 1, 32))
    with pytest.raises(ValueError):
        flash_mha(q, k, k, prefix_len=-1)


def test_contracts_name_every_zoo_head_dim():
    """The kernels take every head dim of the zoo's full configs: 64
    (SmolLM), 128, 192 (Nemotron) and 256 (PaliGemma, RecurrentGemma),
    and up to 16 query heads per kv head in both decode wrappers (flash
    and paged prefill tile any G)."""
    for mod in (flash_ops, dec_ops, pa_ops, pp_ops):
        assert mod.HEAD_DIMS == (32, 64, 128, 192, 256)
    assert dec_ops.MAX_GROUP == pa_ops.MAX_GROUP == 16
