"""The arithmetic of the bf16 SGMV kernel (``csrc/sgmv.cu``), emulated in
plain PyTorch on the CPU and held against the reference's Pallas kernel in
interpret mode and the port's plain version.

The kernel cuts the rows into tiles of ``TILE_M`` consecutive rows.  A
tile runs one pass per distinct in-range adapter id, in the order of the
rows that first carry it; a pass covers exactly the tile's rows with that
id, and a row whose id lies outside [0, N) is in no pass and is written as
zeros.  A cluster of C CTAs takes a tile (the library's plan, copied below
as ``plan``): the input features are cut into chunks of ``CHUNK``, CTA c
takes chunks [c per, (c + 1) per) (per = ceil(chunks / C); a CTA past the
last chunk takes none) and forms, per pass and row, the float32 sum of
bf16 products over its slice (tensor-core products with float32 sums).
Every CTA then adds the C slices' partials in order of slice: xa, float32.
The grid gives the tile ``osplit`` copies of its cluster, each repeating
the shrink; CTA c of copy o expands column tiles (o C + c), (o C + c) + OS
C, ... of ``cols`` columns: y = scaling * xa @ B[ad] in float32, rounded
once to the output dtype.  Every column of a tile is expanded by exactly
one CTA.

Tolerances, as ``chip_smoke.py`` holds the kernel to the plain version
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
from repro_torch.kernels.sgmv.ops import TILE_M
from repro_torch.kernels.sgmv.ref import sgmv_ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SCALING = 2.0

# csrc/sgmv.cu's constants
CHUNK = 128              # input features per stage (two 64-feature x boxes)
TARGET_CTAS = 128        # about one CTA an SM at few rows
SMS = 132
MAX_COLS = 1024          # columns of a CTA's tile: 8 a thread
MAX_OSPLIT = 16


def plan(R: int, D: int, O: int):
    """(cluster, osplit, cols) of a call: a cluster of 16 CTAs for one
    tile and for up to 4 tiles of 64 chunks or more, else 8, or 4 where 8
    a tile would leave more than 1.5 CTAs an SM (fewer where D has fewer
    chunks); as many copies over O as keep the
    grid near TARGET_CTAS CTAs (each CTA at least 8 columns); column tiles
    (a power of two, 8..MAX_COLS) that give the busiest CTA of a copy's
    cluster the least work: a tile costs a reload of B (about 4 rows'
    FMAs a thread) plus its rows x columns / 1024 a thread; ties to the
    wider tile."""
    tiles, chunks = -(-R // TILE_M), -(-D // CHUNK)
    c = (16 if tiles <= 4 and (tiles == 1 or chunks >= 64)
         else 8 if 2 * tiles * 8 <= 3 * SMS else 4)
    while c > 1 and c > chunks:
        c //= 2
    os_ = 1
    while (os_ < MAX_OSPLIT and tiles * c * os_ * 2 <= TARGET_CTAS
           and os_ * 2 * c * 8 <= O):
        os_ *= 2
    ctas, rows, best, cols = os_ * c, min(R, TILE_M), None, None
    for w in (MAX_COLS >> i for i in range(8)):           # 1024 .. 8
        cost = -(-(-(-O // w)) // ctas) * (4 * 1024 + w * rows)
        if best is None or cost < best:
            best, cols = cost, w
    return c, os_, cols


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


def cluster_emulation(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      idx: torch.Tensor, scaling: float):
    """x (R, D), a (N, D, r), b (N, r, O), idx (R,).  Returns y (R, O) in
    x's dtype, the passes of each tile and the slices [(lo, hi)] of the
    cluster's CTAs."""
    R, D = x.shape
    N, _, r = a.shape
    O = b.shape[2]
    C, osplit, cols = plan(R, D, O)
    chunks = -(-D // CHUNK)
    per = -(-chunks // C)
    slices = [(min(chunks, c * per) * CHUNK,
               min(D, min(chunks, c * per + per) * CHUNK)) for c in range(C)]
    ids = torch.where((idx >= 0) & (idx < N), idx.long(),
                      torch.full_like(idx.long(), -1))
    passes = tile_passes(ids)
    y = torch.zeros(R, O)
    n_tiles = -(-O // cols)
    for t, order in enumerate(passes):
        t0 = t * TILE_M
        tile = ids[t0:t0 + TILE_M]
        red = torch.zeros(C, len(tile), r)         # each CTA's partials
        for c, (lo, hi) in enumerate(slices):
            for ad in order:
                rows = torch.nonzero(tile == ad).flatten()
                if hi > lo:
                    red[c, rows] = (x[t0 + rows, lo:hi].float()
                                    @ a[ad, lo:hi].float())
        xa = torch.zeros(len(tile), r)
        for c in range(C):                         # in order of slice
            xa = xa + red[c]
        seen = torch.zeros(O, dtype=torch.int64)
        for copy in range(osplit):
            for c in range(C):
                for ct in range(copy * C + c, n_tiles, osplit * C):
                    o0, o1 = ct * cols, min(O, (ct + 1) * cols)
                    seen[o0:o1] += 1
                    for i, ad in enumerate(tile.tolist()):
                        if ad >= 0:
                            y[t0 + i, o0:o1] = scaling * (
                                xa[i] @ b[ad, :, o0:o1].float())
        assert bool((seen == 1).all()), "a column expanded twice or never"
    return y.to(x.dtype), passes, slices


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
    # 5 tiles, 8 chunks: a cluster of 8 CTAs of one chunk each
    "four-clusters": (320, 1000, 72, 4, 16,
                      _runs([80] * 4, [3, 1, 0, 2]), [1, 2, 2, 2, 1]),
    # 17 chunks over 8 CTAs: three a CTA, the last ragged, one CTA idle
    "multi-chunk-slices": (520, 2040, 72, 4, 16,
                           _runs([130] * 4, [0, 1, 2, 3]),
                           [1, 1, 2, 1, 2, 1, 2, 1, 1]),
    "rank-8": (70, 200, 72, 4, 8, _runs([35, 35], [0, 3]), [2, 1]),
    # the decode rows: the warm-function batch of 3 (one adapter) and the
    # runtime's 8 interleaved over 4, each one tile over 4 copies of its
    # cluster; the runtime's prefill of 4 runs of 64; the launcher's 3 x
    # 500 of one adapter
    "R3-one-adapter": (3, 1040, 256, 4, 16, np.full(3, 2, np.int32), [1]),
    "R8-interleaved": (8, 1040, 256, 4, 16,
                       np.arange(8, dtype=np.int32) % 4, [4]),
    "4-runs-of-64": (256, 1040, 200, 4, 16, _runs([64] * 4, [0, 1, 2, 3]),
                     [1, 1, 1, 1]),
    "3x500": (1500, 264, 136, 4, 16, _runs([500] * 3, [1, 1, 1]),
              [1] * 24),
    "rank-8-decode": (8, 1040, 256, 4, 8, np.arange(8, dtype=np.int32) % 4,
                      [4]),
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
    emu, passes, slices = cluster_emulation(x, a, b, idx, SCALING)
    assert [len(p) for p in passes] == n_passes
    bad = (idx < 0) | (idx >= N)
    # every in-range row is in exactly one pass of its tile
    for t, order in enumerate(passes):
        tile = idx[t * TILE_M:(t + 1) * TILE_M]
        assert sorted(order) == sorted(set(
            tile[(tile >= 0) & (tile < N)].tolist()))
    assert slices[0][0] == 0 and max(hi for _, hi in slices) == D
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
    """The layouts above reach a cluster smaller than 8 (D of 2 chunks),
    8 CTAs of one chunk each, several chunks a CTA with the last ragged
    and a CTA with none, and a decode batch over 4 copies of 8-column
    tiles."""
    for R, D, O, want in [(150, 200, 72, (2, 4, 16)),
                          (320, 1000, 72, (8, 1, 16)),
                          (520, 2040, 72, (8, 1, 16)),
                          (8, 1040, 256, (8, 4, 8))]:
        assert plan(R, D, O) == want
    chunks, per = -(-2040 // CHUNK), -(-(-(-2040 // CHUNK)) // 8)
    assert (chunks, per) == (16, 2) and 2040 % CHUNK
    _, _, slices = cluster_emulation(*[torch.zeros(s) for s in (
        (1, 1040), (1, 1040, 16), (1, 16, 256))],
        torch.zeros(1, dtype=torch.int32), 1.0)
    assert slices[-1][0] >= slices[-1][1] == 1040   # an idle CTA


# (R, D, O) -> (cluster, osplit, cols): the runtime's and the launcher's
# decode and prefill rows at Llama-2-7B's 4096 -> 4096
@pytest.mark.parametrize("R,C,osplit,cols", [
    (3, 16, 8, 32),          # warm-function decode: 128 CTAs
    (8, 16, 8, 32),          # runtime decode
    (256, 8, 4, 128),        # runtime prefill, 4 x 64 rows
    (1500, 8, 1, 512),       # warm-function prefill, 3 x 500 rows
])
def test_grid_rules_at_main_path_shapes(R, C, osplit, cols):
    """At D = O = 4096 the decode batch's tile is a cluster of 16 CTAs of
    2 chunks each over 8 copies (128 CTAs), a prefill tile 8 CTAs of 4
    chunks, the copies' CTAs covering O once (``chip_smoke.py`` phase 3
    checks that the library returns these)."""
    D = O = 4096
    assert plan(R, D, O) == (C, osplit, cols)
    tiles = -(-R // TILE_M)
    assert tiles * C * osplit <= TARGET_CTAS or osplit == 1
    assert -(-O // cols) <= osplit * C * -(-(-(-O // cols)) // (osplit * C))


@pytest.mark.parametrize("R,D,O,want", [
    (8, 6144, 6144, (16, 8, 64)),         # Mixtral-8x22B q and o
    (256, 6144, 1024, (8, 4, 32)),        # its k and v at prefill
    (8, 18432, 18432, (16, 8, 256)),      # Nemotron-4-340B: 144 chunks
    (256, 18432, 1536, (16, 2, 64)),
    (8, 1536, 6448, (8, 16, 64)),         # Mamba2-780M's in-projection
    (2048, 960, 960, (4, 1, 256)),        # SmolLM-360M's 8 x 256 rows
    (2048, 5120, 5120, (4, 1, 256)),      # Phi-3-medium-14B's q and o
])
def test_grid_rules_at_other_sites(R, D, O, want):
    assert plan(R, D, O) == want
