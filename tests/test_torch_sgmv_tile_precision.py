"""The arithmetic of the bf16 SGMV kernels (``csrc/sgmv.cu``), emulated in
plain PyTorch on the CPU and held against the reference's Pallas kernel in
interpret mode and the port's plain version.

The kernels cut the rows into tiles of ``TILE_M`` consecutive rows.  A
tile runs one pass per distinct in-range adapter id, in the order of the
rows that first carry it; a pass covers exactly the tile's rows with that
id, and a row whose id lies outside [0, N) is in no pass and is written as
zeros.  The shrink cuts the input features into S slices of
``d_slice(R, D)`` (the wrapper's own rule) and takes, per row and slice,
the float32 sum of bf16 products (tensor-core products with float32
sums).  A cluster of ``CLUSTER`` consecutive slices adds its slices'
partials in order (slices past S, which pad the grid, add zeros) and
writes one partial per row; the expand adds a row's cluster partials in
order.  Then y = scaling * xa @ B[ad] in float32, rounded once to the
output dtype.

Tolerances, as ``chip_smoke.py`` holds the kernels to the plain version
(``TOL``): max |a - b| <= tol * max(1, max |b|), tol = 1e-5 in float32
(the implementations differ only in summation order) and 2^-7 in bfloat16
(each side rounds once).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sgmv.ops import sgmv_apply as jax_sgmv_apply
from repro_torch.kernels.sgmv.ops import (CHUNK, CLUSTER, CTAS_PER_SM,
                                          EXPAND_CTAS_PER_SM, MAX_SLICES,
                                          OUT_TILE, SMS, TILE_M, d_slice,
                                          expand_rows, partials)
from repro_torch.kernels.sgmv.ref import sgmv_ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SCALING = 2.0


def tile_passes(ids: torch.Tensor):
    """The passes of each row tile: its distinct ids >= 0 in order of
    their first row."""
    out = []
    for t0 in range(0, len(ids), TILE_M):
        order = []
        for ad in ids[t0:t0 + TILE_M].tolist():
            if ad >= 0 and ad not in order:
                order.append(ad)
        out.append(order)
    return out


def tile_emulation(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                   idx: torch.Tensor, scaling: float):
    """x (R, D), a (N, D, r), b (N, r, O), idx (R,).  Returns y (R, O) in
    x's dtype, the passes of each tile and the number of slices S."""
    R, D = x.shape
    N, _, r = a.shape
    ds = d_slice(R, D)
    S = -(-D // ds)
    ids = torch.where((idx >= 0) & (idx < N), idx.long(),
                      torch.full_like(idx.long(), -1))
    passes = tile_passes(ids)
    part = torch.zeros(R, S, r)
    for t, order in enumerate(passes):
        t0 = t * TILE_M
        tile = ids[t0:t0 + TILE_M]
        for ad in order:
            rows = t0 + torch.nonzero(tile == ad).flatten()
            for s in range(S):
                d0, d1 = s * ds, min(D, (s + 1) * ds)
                part[rows, s] = x[rows, d0:d1].float() @ a[ad, d0:d1].float()
    sp = partials(D, ds, CLUSTER)
    xa = torch.zeros(R, r)
    for c in range(sp):
        acc = torch.zeros(R, r)
        for s in range(c * CLUSTER, (c + 1) * CLUSTER):
            acc = acc + (part[:, s] if s < S else 0.0)
        xa = xa + acc
    bg = b[ids.clamp(min=0)].float()                      # (R, r, O)
    y = scaling * torch.einsum("rk,rko->ro", xa, bg)
    y = torch.where((ids >= 0)[:, None], y, torch.zeros_like(y))
    return y.to(x.dtype), passes, S


def _inputs(rng, dtype, R, D, O, N, r):
    x = rng.standard_normal((R, D)).astype(np.float32)
    a = (rng.standard_normal((N, D, r)) / np.sqrt(D)).astype(np.float32)
    b = (0.5 * rng.standard_normal((N, r, O))).astype(np.float32)
    return [torch.from_numpy(t).to(dtype) for t in (x, a, b)]


def _j(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype (bf16 exactly)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _assert_close(got: torch.Tensor, want: torch.Tensor, dtype) -> None:
    want = want.float()
    err = float((got.float() - want).abs().max())
    tol = TOL[dtype] * max(1.0, float(want.abs().max()))
    assert err <= tol, (err, tol)


def _runs(lengths, adapters):
    """Token-major ids: run i of ``lengths[i]`` rows carries
    ``adapters[i]``."""
    return np.concatenate([np.full(n, ad, np.int32)
                           for n, ad in zip(lengths, adapters)])


# layout name -> (R, D, O, N, r, ids, passes per tile)
LAYOUTS = {
    # runs of 50 rows: tiles [0, 64) and [64, 128) straddle two requests
    "run-straddles-tile": (150, 200, 72, 4, 16,
                           _runs([50, 50, 50], [2, 0, 3]), [2, 2, 1]),
    # runs of 10 rows, 4 adapters round robin; R = 100 is no tile multiple
    "runs-shorter-than-tile": (100, 200, 72, 4, 16,
                               _runs([10] * 10, [i % 4 for i in range(10)]),
                               [4, 4]),
    "one-adapter": (130, 200, 72, 3, 16, np.full(130, 1, np.int32),
                    [1, 1, 1]),
    "every-row-its-own": (40, 200, 72, 40, 16,
                          np.random.default_rng(5).permutation(40).astype(
                              np.int32), [40]),
    # ids -1, N and N + 7 inside a run: exact zeros, in no pass
    "out-of-range-in-run": (96, 200, 72, 4, 16,
                            _runs([48, 48], [1, 2]), [2, 1]),
    "one-adapter-bank": (20, 200, 72, 1, 16,
                         np.where(np.arange(20) == 7, -1, 0).astype(np.int32),
                         [1]),
    "one-row": (1, 200, 72, 2, 16, np.array([1], np.int32), [1]),
    # 5 tiles x 32 slices: four clusters
    "four-clusters": (320, 1000, 72, 4, 16,
                      _runs([80] * 4, [3, 1, 0, 2]), [1, 2, 2, 2, 1]),
    # 9 tiles x 64 chunks > CTAS_PER_SM x SMS: two chunks a slice, the
    # last slice of 56 features
    "multi-chunk-slices": (520, 2040, 72, 4, 16,
                           _runs([130] * 4, [0, 1, 2, 3]),
                           [1, 1, 2, 1, 2, 1, 2, 1, 1]),
    "rank-8": (70, 200, 72, 4, 8, _runs([35, 35], [0, 3]), [2, 1]),
}

DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tile_emulation_matches_pallas_and_plain(layout, dtype):
    R, D, O, N, r, ids, n_passes = LAYOUTS[layout]
    ids = ids.copy()
    if layout == "out-of-range-in-run":
        ids[[5, 17, 30]] = [-1, N, N + 7]
    rng = np.random.default_rng(R + D + N + r)
    x, a, b = _inputs(rng, dtype, R, D, O, N, r)
    idx = torch.from_numpy(ids)
    emu, passes, S = tile_emulation(x, a, b, idx, SCALING)
    assert [len(p) for p in passes] == n_passes
    bad = (idx < 0) | (idx >= N)
    # every in-range row is in exactly one pass of its tile
    for t, order in enumerate(passes):
        tile = idx[t * TILE_M:(t + 1) * TILE_M]
        assert sorted(order) == sorted(set(
            tile[(tile >= 0) & (tile < N)].tolist()))
    assert S == -(-D // d_slice(R, D))
    pallas = jax_sgmv_apply(_j(x), _j(a), _j(b), jnp.asarray(ids),
                            scaling=SCALING, use_kernel=True)
    pallas = torch.from_numpy(np.array(jnp.asarray(pallas, jnp.float32)))
    plain = sgmv_ref(x, a, b, idx, scaling=SCALING)
    _assert_close(emu, pallas, dtype)
    _assert_close(emu, plain, dtype)
    if bool(bad.any()):
        assert not bool(emu[bad].any())
        assert not bool(plain[bad].any())
        assert not bool(pallas[bad].any())


def test_layouts_reach_every_slice_shape():
    """The layouts above reach one padded cluster (S = 7), several
    clusters of one-chunk slices (S = 32) and slices of two chunks, the
    last one ragged."""
    for R, D, S, ds, sp in [(150, 200, 7, CHUNK, 1), (320, 1000, 32, CHUNK, 4),
                            (520, 2040, 32, 2 * CHUNK, 4)]:
        assert d_slice(R, D) == ds
        assert -(-D // ds) == S
        assert partials(D, ds, CLUSTER) == sp


@pytest.mark.parametrize("R,S,ctas,erows", [
    (3, 128, 128, 16),       # warm-function decode: one chunk per CTA
    (8, 128, 128, 16),       # runtime decode
    (256, 128, 512, 16),     # runtime prefill, 4 x 64 rows
    (1500, 22, 576, 64),     # warm-function prefill, 3 x 500 rows
])
def test_grid_rules_at_main_path_shapes(R, S, ctas, erows):
    """At D = O = 4096 the decode batch spreads over every 32-feature chunk;
    prefill is cut no finer than CTAS_PER_SM shrink CTAs an SM need; the
    grid pads the slices to whole clusters.  The expand takes 64 rows a
    CTA, fewer where that leaves under EXPAND_CTAS_PER_SM CTAs an SM."""
    D = O = 4096
    ds = d_slice(R, D)
    tiles, chunks, per = -(-R // TILE_M), D // CHUNK, ds // CHUNK
    assert ds % CHUNK == 0
    assert -(-D // ds) == S <= MAX_SLICES
    assert tiles * partials(D, ds, CLUSTER) * CLUSTER == ctas
    # the fewest chunks per CTA that keep tiles x slices within the target
    assert tiles * chunks <= CTAS_PER_SM * SMS * per
    assert per == 1 or tiles * chunks > CTAS_PER_SM * SMS * (per - 1)
    assert expand_rows(R, O) == erows
    expand_ctas = -(-R // erows) * (O // OUT_TILE)
    assert erows == 16 or expand_ctas >= EXPAND_CTAS_PER_SM * SMS
