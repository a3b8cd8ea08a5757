"""The port's main-path layers against the reference's, float32 on the CPU,
with the same numpy weights and inputs handed to both.

Tolerance: atol = rtol = 1e-5 (summation order only).  The paged branches
compare the mixer output and the updated pools, including a decode row
whose position lies past the block table (its write must land in the
garbage block, as the reference's out-of-range ``take_along_axis`` fill
makes it) and an inactive row (table all -1, also garbage).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_get_smoke
from repro.models import layers as jl
from repro_torch.configs import get_smoke
from repro_torch.models import layers as tl

TOL = dict(atol=1e-5, rtol=1e-5)
CFG_T = get_smoke("llama2_7b").with_(dtype="float32")
CFG_J = jax_get_smoke("llama2_7b").with_(dtype="float32")


def _both(tree):
    """numpy tree -> (jax tree, torch tree)."""
    if isinstance(tree, dict):
        pairs = {k: _both(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()},
                {k: v[1] for k, v in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def _attn_params(rng, n_adapters=3):
    D, H, K, hd, r = (CFG_T.d_model, CFG_T.num_heads, CFG_T.num_kv_heads,
                      CFG_T.head_dim_, CFG_T.lora.rank)
    dims = {"q": (D, H * hd), "k": (D, K * hd), "v": (D, K * hd),
            "o": (H * hd, D)}

    def mat(*s, scale):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    p = {f"w{t}": {"w": mat(*dims[t], scale=dims[t][0] ** -0.5)}
         for t in dims}
    p["lora"] = {t: {"a": mat(n_adapters, dims[t][0], r,
                              scale=dims[t][0] ** -0.5),
                     "b": mat(n_adapters, r, dims[t][1], scale=0.1)}
                 for t in dims}
    return p


def test_rmsnorm_rope_swiglu():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, CFG_T.d_model)).astype(np.float32)
    scale = rng.standard_normal(CFG_T.d_model).astype(np.float32)
    xj, xt = _both(x)
    pj, pt = _both({"scale": scale})
    np.testing.assert_allclose(
        tl.apply_norm(xt, pt, "rmsnorm").numpy(),
        np.asarray(jl.apply_norm(xj, pj, "rmsnorm")), **TOL)

    q = rng.standard_normal((2, 5, 4, 32)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [17, 18, 19, 20, 21]], np.int32)
    np.testing.assert_allclose(
        tl.rope(torch.from_numpy(q), torch.from_numpy(pos), 10_000.0).numpy(),
        np.asarray(jl.rope(jnp.asarray(q), jnp.asarray(pos), 10_000.0)),
        **TOL)

    D, F = CFG_T.d_model, CFG_T.d_ff
    mlp = {k: {"w": (rng.standard_normal(s) / np.sqrt(s[0])
                     ).astype(np.float32)}
           for k, s in (("wi", (D, F)), ("wg", (D, F)), ("wo", (F, D)))}
    mj, mt = _both(mlp)
    np.testing.assert_allclose(tl.apply_mlp(mt, CFG_T, xt).numpy(),
                               np.asarray(jl.apply_mlp(mj, CFG_J, xj)),
                               **TOL)


def test_dense_with_multi_lora_bank():
    rng = np.random.default_rng(1)
    p = _attn_params(rng)
    x = rng.standard_normal((3, 4, CFG_T.d_model)).astype(np.float32)
    ai = np.array([2, 0, 7], np.int32)       # 7: outside the 3-slot bank
    pj, pt = _both(p)
    got = tl.dense(torch.from_numpy(x), pt["wq"], pt["lora"]["q"],
                   scaling=2.0, adapter_idx=torch.from_numpy(ai)).numpy()
    want = np.asarray(jl.dense(jnp.asarray(x), pj["wq"], pj["lora"]["q"],
                               scaling=2.0, adapter_idx=jnp.asarray(ai)))
    np.testing.assert_allclose(got, want, **TOL)
    base = x[2] @ p["wq"]["w"]               # zero delta for the bad id
    np.testing.assert_allclose(got[2], base, **TOL)


def _pool_pair(rng, NB, bs):
    K, hd = CFG_T.num_kv_heads, CFG_T.head_dim_
    kp = rng.standard_normal((K, NB, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((K, NB, bs, hd)).astype(np.float32)
    return kp, vp


def test_paged_decode_branch_with_overflow_row():
    rng = np.random.default_rng(2)
    NB, bs, MB = 24, 8, 4
    p = _attn_params(rng)
    kp, vp = _pool_pair(rng, NB, bs)
    x = rng.standard_normal((4, 1, CFG_T.d_model)).astype(np.float32)
    tbl = np.full((4, MB), -1, np.int32)
    tbl[0, :3] = [5, 9, 2]
    tbl[1] = [3, 4, 6, 7]
    tbl[2] = [10, 11, 12, 13]
    # row 0: live; row 1: position past the table (stalled slot: its write
    # lands in the garbage block); row 2: live, last position of the
    # table; row 3: inactive (all -1)
    pos = np.array([[19], [MB * bs + 3], [MB * bs - 1], [0]], np.int32)
    ai = np.array([1, 0, 2, 0], np.int32)
    pj, pt = _both(p)
    out_j, cache_j = jl.apply_attention(
        pj, CFG_J, jnp.asarray(x), positions=jnp.asarray(pos),
        cache={"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)},
        adapter_idx=jnp.asarray(ai), block_tbl=jnp.asarray(tbl),
        use_paged_kernel=True)
    cache_t = {"kp": torch.from_numpy(kp.copy()),
               "vp": torch.from_numpy(vp.copy())}
    out_t = tl.apply_attention(
        pt, CFG_T, torch.from_numpy(x), positions=torch.from_numpy(pos),
        cache=cache_t, block_tbl=torch.from_numpy(tbl),
        adapter_idx=torch.from_numpy(ai))
    live = [0, 2]
    np.testing.assert_allclose(out_t.numpy()[live],
                               np.asarray(out_j)[live], **TOL)
    for name in ("kp", "vp"):
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), **TOL)
    # the overflow row and the inactive row both wrote the garbage block
    assert not np.allclose(cache_t["kp"].numpy()[:, 0], kp[:, 0])


@pytest.mark.parametrize("start", [[0, 8], [16, 0]])
def test_paged_prefill_branch(start):
    rng = np.random.default_rng(3)
    NB, bs, MB, C = 24, 8, 6, 16
    p = _attn_params(rng)
    kp, vp = _pool_pair(rng, NB, bs)
    B = 3                                   # row 2 is a padding row
    x = rng.standard_normal((B, C, CFG_T.d_model)).astype(np.float32)
    tbl = np.full((B, MB), -1, np.int32)
    tbl[0, :4] = [3, 4, 5, 6]
    tbl[1, :3] = [8, 9, 10]
    st = np.array(start + [0], np.int32)
    pos = (st[:, None] + np.arange(C)[None]).astype(np.int32)
    ids = np.zeros((B, C // bs), np.int32)  # garbage = skipped write
    for b in range(2):
        for jj in range(C // bs):
            j = st[b] // bs + jj
            if tbl[b, j] >= 0:
                ids[b, jj] = tbl[b, j]
    ai = np.array([2, 1, 0], np.int32)
    pj, pt = _both(p)
    out_j, cache_j = jl.apply_attention(
        pj, CFG_J, jnp.asarray(x), positions=jnp.asarray(pos),
        cache={"kp": jnp.asarray(kp), "vp": jnp.asarray(vp)},
        adapter_idx=jnp.asarray(ai), block_tbl=jnp.asarray(tbl),
        chunk_ids=jnp.asarray(ids), use_paged_kernel=True)
    cache_t = {"kp": torch.from_numpy(kp.copy()),
               "vp": torch.from_numpy(vp.copy())}
    out_t = tl.apply_attention(
        pt, CFG_T, torch.from_numpy(x), positions=torch.from_numpy(pos),
        cache=cache_t, block_tbl=torch.from_numpy(tbl),
        adapter_idx=torch.from_numpy(ai), chunk_ids=torch.from_numpy(ids))
    np.testing.assert_allclose(out_t.numpy()[:2], np.asarray(out_j)[:2],
                               **TOL)
    # several rows write the garbage block 0 (any order wins): compare the
    # real blocks
    for name in ("kp", "vp"):
        np.testing.assert_allclose(cache_t[name].numpy()[:, 1:],
                                   np.asarray(cache_j[name])[:, 1:], **TOL)
