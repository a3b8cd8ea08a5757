"""The arithmetic of the split-KV decode kernels (ring decode,
``csrc/decode_attn.cu``, and paged decode, ``csrc/paged_attn.cu``, on the
partition step of ``csrc/decode_tile.cuh`` and the merge
``rt::split_kv_merge_kernel`` of ``csrc/common.cuh``), emulated in plain
PyTorch on the CPU and held against the reference's Pallas kernels in
interpret mode and the port's plain versions.

The kernels cut a row's slots into partitions of the wrappers' own
``PARTITION`` (slots [s * P, (s + 1) * P) of the ring, or logical tokens of
the block table).  A partition takes float32 scores of its attended slots,
its own max m and sum l of exp(score - m) (exactly 0 for a slot that is
not attended) and the unnormalised float32 acc = sum p * v; one with no
attended slot reports m = -inf, l = 0, acc = 0.  The merge takes M, the
max of the partitions' m, weighs partition s by exp(m_s - M) (0 for an
empty one), divides sum w acc by max(sum w l, 1e-30) and rounds once to
the output dtype, so a row with no attended slot yields exact zeros.

Tolerances, as ``chip_smoke.py`` holds the kernels to the plain versions
(``TOL``): max |a - b| <= tol * max(1, max |b|), tol = 1e-5 in float32
(the implementations differ only in summation order) and 2^-7 in bfloat16
(each side rounds once; the Pallas kernels also round P to bf16 before
P V, a few bf16 units of the output at most).  The reference's rows with
no attended key are junk by its own account (it averages the garbage
block), so an inactive row is held only to the plain version: exact zeros.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_gqa as jax_decode_gqa
from repro.kernels.paged_attention.ops import \
    paged_decode_gqa as jax_paged_decode
from repro_torch.kernels.decode_attention.ops import \
    PARTITION as RING_PARTITION
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.paged_attention.ops import \
    PARTITION as PAGED_PARTITION
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
NEG_INF = -math.inf


def split_kv_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       ok: torch.Tensor, part: int):
    """q (R, G, hd); k, v (R, S, hd); ok (R, S): R independent (row, kv
    head) pairs over S slots.  Returns the output (R, G, hd) in q's dtype
    and the partitions' m (R, G, NP)."""
    hd = q.shape[-1]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    scores = torch.einsum("rgh,rsh->rgs", q.float(), k.float()) * scale
    ms, ls, accs = [], [], []
    for t0 in range(0, k.shape[1], part):
        okp = ok[:, None, t0:t0 + part]
        s = torch.where(okp, scores[..., t0:t0 + part],
                        torch.full_like(scores[..., t0:t0 + part], NEG_INF))
        live = okp.any(dim=-1)                      # (R, 1)
        m = torch.where(live, s.amax(dim=-1), torch.full_like(s[..., 0],
                                                              NEG_INF))
        p = torch.where(okp, torch.exp(s - torch.where(
            live, m, torch.zeros_like(m))[..., None]), torch.zeros_like(s))
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(p @ v[:, t0:t0 + part].float())
    m = torch.stack(ms, dim=-1)                     # (R, G, NP)
    l = torch.stack(ls, dim=-1)
    acc = torch.stack(accs, dim=2)                  # (R, G, NP, hd)
    mx = m.amax(dim=-1, keepdim=True)
    w = torch.where(m == NEG_INF, torch.zeros_like(m),
                    torch.exp(m - torch.where(mx == NEG_INF,
                                              torch.zeros_like(mx), mx)))
    num = (w[..., None] * acc).sum(dim=2)
    den = (w * l).sum(dim=-1)
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.to(q.dtype), m


def _inputs(rng, dtype, *shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _j(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype (bf16 exactly)."""
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


DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]


# -------------------------------------------------------------- ring decode
def _ring(B, S, K, G, hd, pos, window, dtype, seed):
    rng = np.random.default_rng(seed)
    q = _inputs(rng, dtype, B, K * G, hd)
    k = _inputs(rng, dtype, B, S, K, hd)
    v = _inputs(rng, dtype, B, S, K, hd)
    written = np.arange(max(0, pos - S + 1), pos + 1)
    slot_pos = np.full(S, -1, np.int32)
    slot_pos[written % S] = written
    sp = torch.from_numpy(slot_pos)
    ok = (sp >= 0) & (sp <= pos)
    if window is not None:
        ok = ok & (sp > pos - window)
    emu, m = split_kv_emulation(
        q.reshape(B * K, G, hd), k.permute(0, 2, 1, 3).reshape(B * K, S, hd),
        v.permute(0, 2, 1, 3).reshape(B * K, S, hd),
        ok[None].expand(B * K, S), RING_PARTITION)
    return q, k, v, sp, emu.reshape(B, K * G, hd), m


RING_CASES = [
    # B, S, K, G, hd, pos, window
    pytest.param(2, 150, 2, 1, 64, 2 * 150 + 17, None, id="wrapped"),
    pytest.param(1, 200, 2, 1, 128, 150, 20, id="window-empties-parts"),
    pytest.param(2, 100, 2, 4, 32, 90, None, id="gqa-G4"),
    pytest.param(1, 150, 1, 12, 192, 170, None, id="wrapped-G12-hd192"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,K,G,hd,pos,window", RING_CASES)
def test_ring_split_matches_pallas_and_plain(B, S, K, G, hd, pos, window,
                                             dtype):
    q, k, v, sp, emu, m = _ring(B, S, K, G, hd, pos, window, dtype,
                                seed=S + hd + G)
    assert m.shape[-1] == -(-S // RING_PARTITION) > 1
    if window is not None:              # whole partitions hold no slot
        assert bool((m == NEG_INF).any()) and bool((m > NEG_INF).any())
    pallas = jax_decode_gqa(_j(q), _j(k), _j(v), jnp.asarray(sp.numpy()),
                            jnp.asarray(pos, jnp.int32), window=window)
    _assert_close(emu, pallas, dtype)
    plain = decode_attention_ref(q, k, v, sp, pos, window=window)
    _assert_close(emu, plain, dtype)


# ------------------------------------------------------------- paged decode
def _paged(K, G, hd, bs, MB, pos, holes, window, dtype, seed):
    """Rows at positions ``pos``; a row at position 0 with no table entry
    is inactive; ``holes`` are (row, logical block) entries set to -1."""
    rng = np.random.default_rng(seed)
    B, NB = len(pos), 2 + len(pos) * MB
    q = _inputs(rng, dtype, B, K * G, hd)
    kp = _inputs(rng, dtype, K, NB, bs, hd)
    vp = _inputs(rng, dtype, K, NB, bs, hd)
    tbl = np.full((B, MB), -1, np.int32)
    perm = rng.permutation(np.arange(1, NB))      # never the garbage block
    for b, p in enumerate(pos):
        if p > 0:
            tbl[b, :p // bs + 1] = perm[b * MB:b * MB + p // bs + 1]
    for b, j in holes:
        tbl[b, j] = -1
    tbl_t = torch.from_numpy(tbl)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    t = torch.arange(MB * bs)
    ok = (t[None] <= pos_t[:, None]) & (tbl_t[:, t // bs] >= 0)
    if window is not None:
        ok = ok & (t[None] > pos_t[:, None] - window)
    phys = tbl_t.clamp(min=0).long()
    kl = kp[:, phys].permute(1, 0, 2, 3, 4).reshape(B * K, MB * bs, hd)
    vl = vp[:, phys].permute(1, 0, 2, 3, 4).reshape(B * K, MB * bs, hd)
    emu, m = split_kv_emulation(
        q.reshape(B * K, G, hd), kl, vl,
        ok[:, None].expand(B, K, MB * bs).reshape(B * K, MB * bs),
        PAGED_PARTITION)
    return q, kp, vp, tbl_t, pos_t, emu.reshape(B, K * G, hd), m


PAGED_CASES = [
    # K, G, hd, bs, MB, pos, holes, window
    pytest.param(2, 1, 64, 16, 12, [150, 70, 0], [(0, 3), (1, 0)], None,
                 id="holes-inactive-row"),
    pytest.param(1, 4, 128, 16, 12, [181, 40], [], None, id="gqa-G4"),
    pytest.param(2, 1, 64, 24, 8, [170, 100], [(0, 1)], 90,
                 id="boundary-inside-block-window90"),
    pytest.param(1, 12, 192, 16, 10, [140, 0], [(0, 4)], None,
                 id="G12-hd192-inactive-row"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("K,G,hd,bs,MB,pos,holes,window", PAGED_CASES)
def test_paged_split_matches_pallas_and_plain(K, G, hd, bs, MB, pos, holes,
                                              window, dtype):
    q, kp, vp, tbl, pos_t, emu, m = _paged(K, G, hd, bs, MB, pos, holes,
                                           window, dtype, seed=hd + bs + G)
    assert m.shape[-1] == -(-(MB * bs) // PAGED_PARTITION) > 1
    if bs == 24:                # partitions of P slots end inside a block
        assert PAGED_PARTITION % bs != 0
    plain = paged_attention_ref(q, kp, vp, tbl, pos_t, window=window)
    _assert_close(emu, plain, dtype)
    active = [b for b, p in enumerate(pos) if p > 0]
    for b in set(range(len(pos))) - set(active):
        assert not emu[b].any() and not plain[b].any()
    pallas = jax_paged_decode(_j(q), _j(kp), _j(vp), jnp.asarray(tbl.numpy()),
                              jnp.asarray(pos_t.numpy()), window=window,
                              interpret=True)
    pallas = torch.from_numpy(np.array(jnp.asarray(pallas, jnp.float32)))
    _assert_close(emu[active], pallas[active], dtype)


def test_emulation_merge_is_exact_for_one_partition():
    """With one partition the merge's weight is exp(0) = 1, so the
    emulation is the plain float32 softmax up to summation order; with an
    empty partition beside it the result is bit for bit the same."""
    rng = np.random.default_rng(3)
    q = _inputs(rng, torch.float32, 2, 1, 32)
    k = _inputs(rng, torch.float32, 2, 2 * RING_PARTITION, 32)
    v = _inputs(rng, torch.float32, 2, 2 * RING_PARTITION, 32)
    ok = torch.zeros(2, 2 * RING_PARTITION, dtype=torch.bool)
    ok[:, :RING_PARTITION] = True
    two, m = split_kv_emulation(q, k, v, ok, RING_PARTITION)
    one, _ = split_kv_emulation(q, k[:, :RING_PARTITION],
                                v[:, :RING_PARTITION],
                                ok[:, :RING_PARTITION], RING_PARTITION)
    assert bool((m[..., 1] == NEG_INF).all())
    assert torch.equal(two, one)


# ------------------------------------------------------- the lane layout
def row_layout(hd: int, elem_bytes: int):
    """``RowLayout`` of ``csrc/decode_tile.cuh``: a row of hd elements as
    16-byte chunks over LPR lanes (the chunk count rounded up to a power
    of two, at most 32), lane c holding chunks c, c + LPR, ... below the
    chunk count.  Returns (LPR, the chunks of each lane)."""
    ch = hd * elem_bytes // 16
    lpr = 32 if ch >= 32 else 1 << (ch - 1).bit_length()
    return lpr, [list(range(c, ch, lpr)) for c in range(lpr)]


@pytest.mark.parametrize("elem_bytes", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("hd", [32, 64, 128, 192, 256])
def test_row_layout_covers_each_chunk_once(hd, elem_bytes):
    lpr, lanes = row_layout(hd, elem_bytes)
    ch = hd * elem_bytes // 16
    assert 32 % lpr == 0
    assert sorted(c for lane in lanes for c in lane) == list(range(ch))
    if hd == 192:                   # ragged: a power-of-two lane count
        assert lpr == 32
        counts = [len(lane) for lane in lanes]
        assert counts == ([1] * 24 + [0] * 8 if elem_bytes == 2
                          else [2] * 16 + [1] * 16)


def lane_scores(q: torch.Tensor, k: torch.Tensor, elem_bytes: int):
    """A partition's scores q . k_i in the kernel's order: each lane sums
    the products of its chunks' elements in float32 (an empty slot adds
    zeros), then the lanes' partial sums meet in the xor butterfly of
    ``score_rows`` (offsets LPR / 2, ..., 1).  q (hd,), k (n, hd)."""
    hd = q.shape[-1]
    lpr, lanes = row_layout(hd, elem_bytes)
    epc = 16 // elem_bytes
    part = torch.zeros((lpr, k.shape[0]), dtype=torch.float32)
    for c, chunks in enumerate(lanes):
        for chunk in chunks:
            for e in range(chunk * epc, (chunk + 1) * epc):
                part[c] = part[c] + q[e].float() * k[:, e].float()
    o = lpr // 2
    while o:
        part = part + part[torch.arange(lpr) ^ o]
        o //= 2
    return part[0]


@pytest.mark.parametrize("dtype", DTYPES)
def test_lane_order_scores_match_plain_at_hd192(dtype):
    """Scores summed in the hd-192 lane order agree with the plain float32
    product within the float32 tolerance (1e-5 relative): the layout moves
    no element and drops none."""
    rng = np.random.default_rng(192)
    q = _inputs(rng, dtype, 192)
    k = _inputs(rng, dtype, 16, 192)
    got = lane_scores(q, k, 2 if dtype == torch.bfloat16 else 4)
    want = k.double() @ q.double()
    scale = float((k.double().abs() @ q.double().abs()).max())
    assert float((got.double() - want).abs().max()) <= 1e-5 * max(1.0,
                                                                  scale)
