"""The arithmetic of the bf16 paged decode kernel (``csrc/paged_attn.cu`` on
the step of ``csrc/ring_decode_step.cuh``), emulated in plain PyTorch on
the CPU and held against the reference's Pallas kernel in interpret mode
and the port's plain version.

A cluster of C CTAs takes one (row, kv head) with all of its G <= 16
query heads; the library's plan (``paged_decode_plan``, copied below as
``paged_plan``) picks C and the stage P from the shapes alone, since the
captured decode step reads the rows' positions on the device.  Each CTA
finds its share of its row's live tokens [lo, pos] (lo = pos - window + 1
with a window, else 0) in the kernel: the n stages of P logical tokens
from lo // P that hold the range, CTA c taking stages [c n / C, (c + 1) n
/ C) of them.  The producer copies a stage's blocks whole, so a stage's
slots past pos, before lo or of a block it did not copy hold anything:
they are masked by their bits.  Its four consumer
warps split each stage into 16-slot groups (warp w takes groups w, w + 4,
...) and keep a running float32 (m, l, acc) per head: the group's max
raises m, acc and l are scaled by exp(m_old - m_new), a masked slot's
score is -inf by a select and its V row is replaced by zeros, a group
with no attended slot is skipped; P enters P V rounded to bf16, the
tensor cores' operand.  The warps' triples merge in order of warp into
the CTA's, and the cluster merges its C triples in order of rank: M = max
m, weights exp(m_c - M) (0 for a CTA with no attended slot), output sum w
acc / max(sum w l, 1e-30) rounded once, so a row with no attended token
gives exact zeros.

Tolerances, as ``chip_smoke.py`` holds the kernel to the plain version
(``TOL``): max |a - b| <= tol * max(1, max |b|), tol = 1e-5 in float32
(summation order only) and 2^-7 in bfloat16 (each side rounds once; the
Pallas kernel also rounds P to bf16 before P V).  The reference's rows
with no attended key are junk by its own account (it averages the
garbage block), so an inactive row is held only to the plain version:
exact zeros.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.paged_attn import paged_decode_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
NEG_INF = -math.inf

# rt::ring's constants (csrc/ring_decode_step.cuh)
WARPS = 4                # consumer warps; each takes 16-slot groups
GROUP = 16
STAGE_BYTES = 32 * 1024
MAX_CLUSTER = 8
STAGES = 3
SMS = 132
MAX_G = 16               # query heads a CTA: the rows of the m16 tile


def paged_part(hd: int) -> int:
    """Slots a stage: the most (a power of two, 32..128) whose bf16 K and
    V rows fit STAGE_BYTES, or twice that at hd 192 and 256 (one CTA an
    SM): 128 at hd 64 and below, else 64."""
    part = 128
    while part > 32 and 4 * part * hd > (2 if hd > 128 else 1) * STAGE_BYTES:
        part //= 2
    return part


def paged_plan(B: int, K: int, G: int, MB: int, bs: int, hd: int):
    """(cluster, stage, stages) of a call: the largest cluster (a power of
    two up to MAX_CLUSTER, at most half the stages of the table's span)
    that keeps the grid of B x K clusters within one CTA an SM."""
    assert 1 <= G <= MAX_G
    part = paged_part(hd)
    np_ = -(-(MB * bs) // part)
    c = 1
    while c < MAX_CLUSTER and B * K * c * 2 <= SMS and 2 * c <= np_:
        c *= 2
    return c, part, STAGES


def cta_stages(lo: int, hi: int, part: int, cluster: int):
    """Each CTA's stages (absolute: stage j holds tokens [j P, (j + 1) P))
    of a row whose live tokens are [lo, hi]."""
    n = hi // part - lo // part + 1 if hi >= lo else 0
    first = lo // part
    return [range(first + c * n // cluster, first + (c + 1) * n // cluster)
            for c in range(cluster)]


def _state(K, G, hd):
    return [torch.full((K, G), NEG_INF), torch.zeros(K, G),
            torch.zeros(K, G, hd)]


def _merge(triples):
    """Triples (m, l, acc) merged in order: M = max m, weights exp(m - M)
    (0 where m = -inf).  Returns (M, sum w l, sum w acc)."""
    M = torch.stack([t[0] for t in triples]).amax(dim=0)
    Ms = torch.where(M > NEG_INF, M, torch.zeros_like(M))
    den = torch.zeros_like(M)
    num = torch.zeros_like(triples[0][2])
    for m, l, acc in triples:
        w = torch.where(m > NEG_INF, torch.exp(m - Ms), torch.zeros_like(m))
        num = num + w[..., None] * acc
        den = den + w * l
    return M, den, num


def paged_step_emulation(q, kl, vl, ok, lo: int, hi: int, part: int,
                         cluster: int):
    """One row: q (K, G, hd); kl, vl (K, T, hd) the row's logical K and V
    as the stages hold them (masked slots: anything, NaN included); ok (T,)
    the attended tokens, all in [lo, hi].  Returns the output (K, G, hd) in
    q's dtype and each CTA's number of stages."""
    K, G, hd = q.shape
    T = kl.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf, kf, vf = q.float(), kl.float(), vl.float()
    ctas = []
    walks = cta_stages(lo, hi, part, cluster)
    for stages in walks:
        warps = [_state(K, G, hd) for _ in range(WARPS)]
        for j in stages:
            for grp in range(part // GROUP):   # warp grp % WARPS's group
                t0 = j * part + GROUP * grp
                sl = slice(min(T, t0), min(T, t0 + GROUP))
                okg = ok[sl]                   # slots past T: never
                if not bool(okg.any()):        # the group is skipped
                    continue
                m, l, acc = warps[grp % WARPS]
                s = torch.einsum("kgh,kph->kgp", qf, kf[:, sl]) * scale
                s = torch.where(okg, s, torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(dim=-1))
                alpha = torch.exp(m - m_new)   # 0 at a warp's first group
                p = torch.where(okg, torch.exp(s - m_new[..., None]),
                                torch.zeros_like(s))
                # P rounded to the operands' dtype for P V, as the tensor
                # cores take it; V of a masked slot selected away
                pv = p.to(q.dtype).float()
                vv = torch.where(okg[:, None], vf[:, sl],
                                 torch.zeros_like(vf[:, sl]))
                warps[grp % WARPS] = [
                    m_new, l * alpha + p.sum(dim=-1),
                    acc * alpha[..., None] + pv @ vv]
        ctas.append(_merge(warps))             # the CTA's, in warp order
    M, den, num = _merge(ctas)                 # the cluster's, in rank order
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.to(q.dtype), [len(w) for w in walks]


def _inputs(rng, dtype, *shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _j(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _assert_close(got: torch.Tensor, want, dtype) -> None:
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32)))
    want = want.float()
    err = float((got.float() - want).abs().max())
    tol = TOL[dtype] * max(1.0, float(want.abs().max()))
    assert err <= tol, (err, tol)


def paged_inputs(K, G, hd, bs, MB, pos, holes, window, reclaimed, dtype,
                 seed):
    """Rows at positions ``pos`` over distinct blocks (never the garbage
    block 0); a row at position 0 with no table entry is inactive;
    ``holes`` are (row, logical block) entries set to -1; with
    ``reclaimed`` the blocks wholly before each row's window are -1 too,
    as the runtime's reclamation leaves them.  Returns q, the pools, the
    table, pos and the attended tokens (B, MB bs)."""
    rng = np.random.default_rng(seed)
    B, NB = len(pos), 1 + len(pos) * MB
    q = _inputs(rng, dtype, B, K * G, hd)
    kp = _inputs(rng, dtype, K, NB, bs, hd)
    vp = _inputs(rng, dtype, K, NB, bs, hd)
    tbl = np.full((B, MB), -1, np.int32)
    perm = rng.permutation(np.arange(1, NB))
    for b, p in enumerate(pos):
        if p > 0:
            tbl[b, :p // bs + 1] = perm[b * MB:b * MB + p // bs + 1]
        if reclaimed and window is not None:
            tbl[b, :max(0, p - window + 1) // bs] = -1
    for b, j in holes:
        tbl[b, j] = -1
    tbl_t = torch.from_numpy(tbl)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    t = torch.arange(MB * bs)
    ok = (t[None] <= pos_t[:, None]) & (tbl_t[:, t // bs] >= 0)
    if window is not None:
        ok = ok & (t[None] > pos_t[:, None] - window)
    return q, kp, vp, tbl_t, pos_t, ok


def poisoned(kp, vp, tbl, ok):
    """Copies of the pools with NaN in K and Inf in V at every masked slot
    of a block in a table (past a row's position, before its window) and
    in the whole garbage block 0."""
    bs = kp.shape[2]
    t = torch.arange(ok.shape[1])
    blk = tbl[:, t // bs]
    bad = (blk >= 0) & ~ok
    phys, off = blk[bad].long(), t.expand_as(blk)[bad] % bs
    kk, vk = kp.clone(), vp.clone()
    for pool, x in ((kk, float("nan")), (vk, float("inf"))):
        pool[:, phys, off] = x
        pool[:, 0] = x
    assert bool(bad.any())
    return kk, vk


def emulate(q, kp, vp, tbl, pos, window, cluster, part):
    """The kernel's output over every row, each row's CTAs' stages."""
    B, H, hd = q.shape
    K, _, bs, _ = kp.shape
    G, MB = H // K, tbl.shape[1]
    outs, walks = [], []
    t = torch.arange(MB * bs)
    for b in range(B):
        p = int(pos[b])
        hi = min(p, MB * bs - 1)
        lo = max(0, p - window + 1) if window is not None else 0
        ok = (t >= lo) & (t <= hi) & (tbl[b, t // bs] >= 0)
        phys = tbl[b].clamp(min=0).long()      # -1: whatever block 0 holds
        kl = kp[:, phys].reshape(K, MB * bs, hd)
        vl = vp[:, phys].reshape(K, MB * bs, hd)
        o, w = paged_step_emulation(q[b].reshape(K, G, hd), kl, vl, ok, lo,
                                    hi, part, cluster)
        outs.append(o.reshape(H, hd))
        walks.append(w)
    return torch.stack(outs), walks


DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]

CASES = [
    # K, G, hd, bs, MB, pos, holes, window, reclaimed, nan
    pytest.param(2, 1, 64, 16, 12, [150, 70, 0], [(0, 3)], None, False,
                 False, id="llama-G1-hole-inactive"),
    pytest.param(2, 6, 128, 16, 16, [230, 200], [], 100, True, False,
                 id="G6-window-reclaimed"),
    pytest.param(1, 12, 192, 16, 10, [140, 0], [(0, 4)], None, False, False,
                 id="G12-hd192"),
    pytest.param(1, 16, 256, 16, 10, [150, 90], [], 64, False, False,
                 id="G16-hd256-window"),
    pytest.param(2, 2, 64, 4, 40, [150, 33], [(0, 10)], None, False, False,
                 id="bs4"),
    pytest.param(2, 1, 128, 8, 20, [150, 70], [], None, False, False,
                 id="bs8"),
    pytest.param(2, 4, 64, 12, 14, [160, 50], [], 90, False, False,
                 id="bs12-window"),
    pytest.param(2, 4, 64, 16, 12, [150, 100, 0], [(1, 2)], 70, False, True,
                 id="nan-in-masked-and-garbage"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,G,hd,bs,MB,pos,holes,window,reclaimed,nan",
                         CASES)
def test_paged_step_matches_pallas_and_plain(K, G, hd, bs, MB, pos, holes,
                                             window, reclaimed, nan, dtype):
    q, kp, vp, tbl, pos_t, ok = paged_inputs(
        K, G, hd, bs, MB, pos, holes, window, reclaimed, dtype,
        seed=hd + bs + G)
    B = len(pos)
    cluster, part, _ = paged_plan(B, K, G, MB, bs, hd)
    kk, vk = poisoned(kp, vp, tbl, ok) if nan else (kp, vp)
    emu, walks = emulate(q, kk, vk, tbl, pos_t, window, cluster, part)
    assert bool(torch.isfinite(emu).all())
    plain = paged_attention_ref(q, kp, vp, tbl, pos_t, window=window)
    _assert_close(emu, plain, dtype)
    active = [b for b in range(B) if bool(ok[b].any())]
    for b in set(range(B)) - set(active):  # no attended token: zeros
        assert not emu[b].any() and not plain[b].any()
    pallas = paged_decode_attention(
        _j(q.reshape(B, K, G, hd)), _j(kp), _j(vp), jnp.asarray(tbl.numpy()),
        jnp.asarray(pos_t.numpy()), window=window, interpret=True)
    pallas = torch.from_numpy(np.array(jnp.asarray(pallas, jnp.float32)))
    _assert_close(emu[active], pallas.reshape(B, K * G, hd)[active], dtype)
    if window is not None:
        # the walk starts at the window's first stage: stages wholly
        # before it are never walked
        for b, w in enumerate(walks):
            lo = max(0, pos[b] - window + 1)
            assert sum(w) == pos[b] // part - lo // part + 1


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_live_range_split_over_the_cluster(cluster):
    """Whatever the cluster size, the output is the plain version's, and
    each row's live stages are dealt out in runs that differ by at most
    one stage: rows at 128 and at 800 tokens both spread over the
    cluster, with no CTA left idle while another walks two stages more."""
    dtype = torch.bfloat16
    q, kp, vp, tbl, pos_t, ok = paged_inputs(
        2, 1, 128, 16, 52, [128, 800, 0], [], None, False, dtype, seed=7)
    part = paged_part(128)
    emu, walks = emulate(q, kp, vp, tbl, pos_t, None, cluster, part)
    _assert_close(emu, paged_attention_ref(q, kp, vp, tbl, pos_t), dtype)
    for p, w in zip((128, 800), walks):
        n = p // part + 1
        assert sum(w) == n and max(w) - min(w) <= 1
        assert min(w) == n // cluster
    assert sum(walks[2]) == 1               # the inactive row: one stage


# (B, K, G, MB, bs, hd) of the main path's paged decode -> (cluster,
# slots a stage, stages)
MAIN_PATH_PLANS = [
    pytest.param((8, 32, 1, 64, 16, 128), (1, 64, 3), id="phase4-6-llama"),
    pytest.param((8, 8, 6, 304, 16, 128), (2, 64, 3), id="phase8-mixtral"),
    pytest.param((8, 1, 16, 168, 16, 256), (8, 64, 3), id="phase9-rgemma"),
    pytest.param((8, 8, 12, 132, 16, 192), (2, 64, 3),
                 id="phase11-nemotron"),
    pytest.param((8, 32, 1, 8, 8, 128), (1, 64, 3), id="phase18a-bs8"),
]


@pytest.mark.parametrize("shape,want", MAIN_PATH_PLANS)
def test_paged_plan_at_main_path_shapes(shape, want):
    """The library's rule (``chip_smoke.py`` phase 3 checks that the
    library returns these): 32 KB of K and V a stage (64 KB at hd 192 and
    256), and the largest cluster that keeps the grid within one CTA an
    SM, within half the stages of the table's span."""
    B, K, G, MB, bs, hd = shape
    assert paged_plan(*shape) == want
    cluster, part, stages = want
    assert 4 * part * hd <= (2 if hd > 128 else 1) * STAGE_BYTES
    assert stages == STAGES
    assert B * K * cluster <= SMS or cluster == 1
    assert cluster == MAX_CLUSTER or B * K * cluster * 2 > SMS \
        or 2 * cluster > -(-(MB * bs) // part)
