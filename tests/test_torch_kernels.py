"""The port's kernel wrappers on the CPU (their plain PyTorch versions)
against the reference's Pallas kernels in interpret mode and its jnp
oracles, on the same numpy inputs.

Tolerance: atol = rtol = 1e-5 in float32 — the implementations differ only
in summation order.  Rows whose block table is all -1 (inactive decode
slots) are excluded: the reference averages garbage there, the port
returns zeros; both are discarded by the runtime.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.ops import \
    paged_decode_gqa as jax_paged_decode
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_pa_ref
from repro.kernels.paged_prefill.ops import \
    paged_prefill_gqa as jax_paged_prefill
from repro.kernels.paged_prefill.ref import paged_prefill_ref as jax_pp_ref
from repro.kernels.sgmv.ops import sgmv_apply as jax_sgmv_apply
from repro.kernels.sgmv.ref import sgmv_ref as jax_sgmv_ref
from repro_torch.kernels import KERNEL_REGISTRY, get_kernel
from repro_torch.kernels.paged_attention.ops import paged_decode_gqa
from repro_torch.kernels.paged_prefill.ops import paged_prefill_gqa
from repro_torch.kernels.sgmv.ops import sgmv_apply, sgmv_tokens

TOL = dict(atol=1e-5, rtol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ------------------------------------------------------------------ sgmv
@pytest.mark.parametrize("R,N,ids", [
    (16, 3, "mixed"),           # every adapter, interleaved
    (13, 3, "out_of_range"),    # -1 and N among valid ids
    (10, 1, "mixed"),           # one-adapter bank
    (7, 4, "mixed"),            # R not a multiple of the row block
])
def test_sgmv_matches_pallas_and_oracle(R, N, ids):
    rng = np.random.default_rng(R * 10 + N)
    D, r, O = 64, 8, 48
    x = rng.standard_normal((R, D)).astype(np.float32)
    a = rng.standard_normal((N, D, r)).astype(np.float32) / 8
    b = rng.standard_normal((N, r, O)).astype(np.float32) / 4
    idx = rng.integers(0, N, size=R).astype(np.int32)
    if ids == "out_of_range":
        idx[[1, 5, 9]] = [-1, N, N + 7]
    got = sgmv_apply(_t(x), _t(a), _t(b), _t(idx), scaling=2.0).numpy()
    pallas = np.asarray(jax_sgmv_apply(jnp.asarray(x), jnp.asarray(a),
                                       jnp.asarray(b), jnp.asarray(idx),
                                       scaling=2.0, use_kernel=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    valid = (idx >= 0) & (idx < N)
    oracle = np.asarray(jax_sgmv_ref(jnp.asarray(x), jnp.asarray(a),
                                     jnp.asarray(b),
                                     jnp.asarray(np.where(valid, idx, 0)),
                                     scaling=2.0))
    np.testing.assert_allclose(got[valid], oracle[valid], **TOL)
    assert np.all(got[~valid] == 0.0)          # exact zero rows


def test_sgmv_tokens_repeats_row_adapter():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    a = rng.standard_normal((2, 16, 4)).astype(np.float32)
    b = rng.standard_normal((2, 4, 8)).astype(np.float32)
    idx = np.array([1, 0], np.int32)
    got = sgmv_tokens(_t(x), _t(a), _t(b), _t(idx)).numpy()
    want = np.einsum("btd,bdk,bko->bto", x, a[idx], b[idx])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_sgmv_tokens_takes_ids_expanded_per_token():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16)).astype(np.float32)
    a = rng.standard_normal((3, 16, 4)).astype(np.float32)
    b = rng.standard_normal((3, 4, 8)).astype(np.float32)
    idx = np.array([2, 0], np.int32)
    per_request = sgmv_tokens(_t(x), _t(a), _t(b), _t(idx)).numpy()
    per_token = sgmv_tokens(_t(x), _t(a), _t(b),
                            _t(np.repeat(idx, 3))).numpy()
    np.testing.assert_array_equal(per_token, per_request)
    with pytest.raises(ValueError, match="idx"):
        sgmv_tokens(_t(x), _t(a), _t(b), _t(np.repeat(idx, 2)))


# --------------------------------------------------------- paged decode
def _pools(rng, K, NB, bs, hd):
    kp = rng.standard_normal((K, NB, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((K, NB, bs, hd)).astype(np.float32)
    return kp, vp


@pytest.mark.parametrize("window", [None, 11])
def test_paged_decode_matches_pallas_and_oracle(window):
    rng = np.random.default_rng(3)
    B, K, G, hd, NB, bs, MB = 4, 2, 2, 32, 16, 8, 6
    kp, vp = _pools(rng, K, NB, bs, hd)
    q = rng.standard_normal((B, K * G, hd)).astype(np.float32)
    tbl = np.full((B, MB), -1, np.int32)
    tbl[0] = [3, 7, 1, 9, 12, 5]             # full depth
    tbl[1, :4] = [4, -1, 8, 2]               # a -1 entry mid-history
    tbl[2, :1] = [11]                        # shallow row
    pos = np.array([45, 29, 3, 0], np.int32)  # row 3: inactive (all -1)
    live = [0, 1, 2]
    args = [jnp.asarray(v) for v in (q, kp, vp, tbl, pos)]
    got = paged_decode_gqa(*map(_t, (q, kp, vp, tbl, pos)),
                           window=window).numpy()
    pallas = np.asarray(jax_paged_decode(*args, window=window,
                                         interpret=True))
    oracle = np.asarray(jax_pa_ref(*args, window=window))
    np.testing.assert_allclose(got[live], pallas[live], **TOL)
    np.testing.assert_allclose(got[live], oracle[live], **TOL)
    assert np.all(got[3] == 0.0)             # inactive row: finite zeros


# -------------------------------------------------------- paged prefill
@pytest.mark.parametrize("window", [None, 13])
def test_paged_prefill_matches_pallas(window):
    rng = np.random.default_rng(5)
    B, C, K, G, hd, NB, bs, MB = 3, 16, 2, 2, 32, 20, 8, 6
    kp, vp = _pools(rng, K, NB, bs, hd)
    q = rng.standard_normal((B, C, K * G, hd)).astype(np.float32)
    tbl = np.full((B, MB), -1, np.int32)
    tbl[0, :4] = [2, 3, 10, 11]      # blocks 0-1: prefix history (shared)
    tbl[1, :4] = [5, 6, 7, 8]        # chunk starts mid-block, spans 3 blocks
    tbl[2, :3] = [14, 15, 16]        # prompt ends in block 2: tail padding
    start = np.array([16, 12, 8], np.int32)
    q_pos = (start[:, None] + np.arange(C)[None]).astype(np.int32)
    got = paged_prefill_gqa(*map(_t, (q, kp, vp, tbl, q_pos)),
                            window=window).numpy()
    args = [jnp.asarray(v) for v in (q, kp, vp, tbl, q_pos)]
    pallas = np.asarray(jax_paged_prefill(*args, window=window,
                                          interpret=True))
    oracle = np.asarray(jax_pp_ref(*args, window=window))
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


# ------------------------------------------------------------- wrappers
def test_registry_names_and_counters():
    assert set(KERNEL_REGISTRY) == {"paged_attention", "paged_prefill",
                                    "sgmv"}
    for name in KERNEL_REGISTRY:
        assert isinstance(get_kernel(name).launches, int)


def test_cpu_path_launches_no_kernel():
    """CPU tensors take the plain version and leave the counter alone."""
    before = sgmv_apply.launches
    x = torch.ones((2, 4))
    sgmv_apply(x, torch.ones((1, 4, 2)), torch.ones((1, 2, 3)),
               torch.zeros(2, dtype=torch.int32))
    assert sgmv_apply.launches == before


def test_mixed_devices_raise():
    x = torch.ones((2, 4), device="meta")
    with pytest.raises(ValueError, match="devices"):
        sgmv_apply(x, torch.ones((1, 4, 2)), torch.ones((1, 2, 3)),
                   torch.zeros(2, dtype=torch.int32))
