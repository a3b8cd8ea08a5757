"""The arithmetic of the bf16 ring decode step (``csrc/ring_decode_step.cuh``,
launched by ``csrc/decode_attn.cu``), emulated in plain PyTorch on the CPU
and held against the reference's Pallas kernel in interpret mode and the
port's plain version.

A cluster of C CTAs takes one (row, kv head, group of at most 8 query
heads); the library's plan (``ring_decode_plan``, copied below as
``plan``) picks C and the partition P.  CTA c walks partitions [c per,
(c + 1) per) of P slots (per = ceil(NP / C)) and skips those with no
attended slot.  Its four consumer warps split each partition into 16-slot
groups (warp w takes groups w, w + 4, ...) and each keeps a running
float32 (m, l, acc) per head over its groups: the group's max raises m,
acc and l are scaled by exp(m_old - m_new), a masked slot's score is -inf
by a select and its V row is replaced by zeros (a TMA box copies masked
slots whole, NaN included); P enters P V rounded to bf16, the tensor
cores' operand.  The warps' triples merge in order of warp into the
CTA's, and the cluster merges its C triples in order of rank: M = max m,
weights exp(m_c - M) (0 for a CTA with no attended slot), output sum w acc
/ max(sum w l, 1e-30) rounded once, log-sum-exp M + log(sum w l) (-inf
with no attended slot, whose output is exact zeros).

Tolerances, as ``chip_smoke.py`` holds the kernel to the plain version
(``TOL``): max |a - b| <= tol * max(1, max |b|), tol = 1e-5 in float32
(summation order only) and 2^-7 in bfloat16 (each side rounds once; the
Pallas kernel also rounds P to bf16 before P V).  The log-sum-exp is
float32 on both sides: within 1e-5.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_gqa as jax_decode_gqa
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
LSE_TOL = 1e-5
NEG_INF = -math.inf

# rt::ring's constants (csrc/ring_decode_step.cuh)
MAX_G = 8
WARPS = 4                # consumer warps; each takes 16-slot groups
GROUP = 16
STAGE_BYTES = 32 * 1024
MAX_CLUSTER = 8
STAGES = 3
SMS = 132


def part_for(hd: int) -> int:
    """Slots a partition: the most (a power of two, 32..128) whose bf16 K
    and V rows fit STAGE_BYTES."""
    part = 128
    while part > 32 and 4 * part * hd > STAGE_BYTES:
        part //= 2
    return part


def plan(B: int, K: int, G: int, S: int, hd: int):
    """(cluster, partition, stages) of a call: the largest cluster (a
    power of two up to MAX_CLUSTER, at most half the partitions) that
    keeps the grid within one CTA an SM, so that every cluster is
    resident at once."""
    part = part_for(hd)
    units = B * K * -(-G // MAX_G)
    np_ = -(-S // part)
    c = 1
    while c < MAX_CLUSTER and units * c * 2 <= SMS and 2 * c <= np_:
        c *= 2
    return c, part, STAGES


def _state(R, G, hd):
    return [torch.full((R, G), NEG_INF), torch.zeros(R, G),
            torch.zeros(R, G, hd)]


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


def ring_step_emulation(q, k, v, ok, part: int, cluster: int):
    """q (R, G, hd); k, v (R, S, hd); ok (R, S): R independent (row, kv
    head) pairs.  Returns the output (R, G, hd) in q's dtype, the
    log-sum-exp (R, G) and the number of live partitions each CTA of the
    first pair walked."""
    R, G, hd = q.shape
    S = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    n_parts = -(-S // part)
    per = -(-n_parts // cluster)
    qf, kf, vf = q.float(), k.float(), v.float()
    ctas, walked = [], []
    for c in range(cluster):
        warps = [_state(R, G, hd) for _ in range(WARPS)]
        live_parts = 0
        for j in range(c * per, min(n_parts, (c + 1) * per)):
            live_parts += int(ok[0, j * part:(j + 1) * part].any())
            for grp in range(part // GROUP):   # warp grp % WARPS's group
                sl = slice(min(S, j * part + GROUP * grp),
                           min(S, j * part + GROUP * (grp + 1)))
                if sl.start == sl.stop:                       # past S
                    continue
                okg = ok[:, sl]                               # (R, 16)
                live = okg.any(dim=-1)[:, None]               # (R, 1)
                m, l, acc = warps[grp % WARPS]
                s = torch.einsum("rgh,rph->rgp", qf, kf[:, sl]) * scale
                s = torch.where(okg[:, None], s, torch.full_like(s, NEG_INF))
                m_new = torch.where(live, torch.maximum(m, s.amax(dim=-1)),
                                    m)
                fin = m_new > NEG_INF
                m_safe = torch.where(fin, m_new, torch.zeros_like(m_new))
                alpha = torch.where(fin, torch.exp(m - m_safe),
                                    torch.ones_like(m))
                p = torch.where(okg[:, None], torch.exp(s - m_safe[..., None]),
                                torch.zeros_like(s))
                # P rounded to the operands' dtype for P V, as the tensor
                # cores take it; V of a masked slot selected away
                pv = p.to(q.dtype).float()
                vv = torch.where(okg[..., None], vf[:, sl],
                                 torch.zeros_like(vf[:, sl]))
                warps[grp % WARPS] = [
                    m_new,
                    torch.where(live, l * alpha + p.sum(dim=-1), l),
                    torch.where(live[..., None],
                                acc * alpha[..., None] + pv @ vv, acc)]
        ctas.append(_merge(warps))             # the CTA's, in warp order
        walked.append(live_parts)
    M, den, num = _merge(ctas)                 # the cluster's, in rank order
    out = num / torch.clamp(den, min=1e-30)[..., None]
    lse = torch.where(M > NEG_INF, M + torch.log(torch.clamp(den, min=1e-30)),
                      torch.full_like(M, NEG_INF))
    return out.to(q.dtype), lse, walked


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


DTYPES = [pytest.param(torch.float32, id="f32"),
          pytest.param(torch.bfloat16, id="bf16")]

CASES = [
    # B, S, K, G, hd, pos, window, nan_in_masked
    pytest.param(2, 300, 2, 1, 64, 2 * 300 + 17, None, False,
                 id="wrapped"),
    pytest.param(1, 600, 2, 1, 128, 500, 70, False, id="window"),
    pytest.param(1, 150, 1, 12, 192, 170, None, False, id="G12-hd192"),
    pytest.param(1, 200, 1, 16, 256, 260, 100, False, id="G16-hd256"),
    pytest.param(2, 1500, 2, 1, 64, 1499, None, False, id="1500-slots"),
    pytest.param(1, 100, 2, 2, 32, -1, None, False, id="no-attended-slot"),
    pytest.param(2, 256, 2, 4, 128, 150, 90, True, id="nan-in-masked"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,K,G,hd,pos,window,nan", CASES)
def test_ring_step_matches_pallas_and_plain(B, S, K, G, hd, pos, window,
                                            nan, dtype):
    rng = np.random.default_rng(S + hd + G)
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
    k_in, v_in = k, v
    if nan:                     # a stale lap or a fresh cache: anything
        assert bool((~ok).any())
        k_in, v_in = k.clone(), v.clone()
        k_in[:, ~ok] = float("nan")
        v_in[:, ~ok] = float("inf")
    cluster, part, _ = plan(B, K, G, S, hd)
    groups = -(-G // MAX_G)
    outs, lses, walked = [], [], None
    for g in range(groups):    # each group of 8 heads a cluster of its own
        hs = slice(g * MAX_G, min(G, (g + 1) * MAX_G))
        qg = q.reshape(B, K, G, hd)[:, :, hs]
        o, lse, w = ring_step_emulation(
            qg.reshape(B * K, -1, hd),
            k_in.permute(0, 2, 1, 3).reshape(B * K, S, hd),
            v_in.permute(0, 2, 1, 3).reshape(B * K, S, hd),
            ok[None].expand(B * K, S), part, cluster)
        outs.append(o.reshape(B, K, -1, hd))
        lses.append(lse.reshape(B, K, -1))
        walked = walked or w
    emu = torch.cat(outs, dim=2).reshape(B, K * G, hd)
    emu_lse = torch.cat(lses, dim=2).reshape(B, K * G)
    assert bool(torch.isfinite(emu).all())
    plain, plain_lse = decode_attention_ref(q, k, v, sp, pos, window=window,
                                            return_lse=True)
    _assert_close(emu, plain, dtype)
    if not bool(ok.any()):     # no attended slot: exact zeros, lse -inf
        assert not bool(emu.any()) and not bool(plain.any())
        assert bool((emu_lse == NEG_INF).all())
        assert bool((plain_lse == NEG_INF).all())
        return
    assert float((emu_lse - plain_lse).abs().max()) <= LSE_TOL
    pallas = jax_decode_gqa(_j(q), _j(k), _j(v), jnp.asarray(slot_pos),
                            jnp.asarray(pos, jnp.int32), window=window)
    _assert_close(emu, pallas, dtype)
    if window is not None and S // part >= 4:
        # the window leaves dead partitions that no CTA walks
        assert sum(walked) < -(-S // part)


# (B, K, G, S, hd) of phase 3's ring decode cases -> (cluster, partition)
MAIN_PATH_PLANS = [
    pytest.param((3, 32, 1, 540, 128), (1, 64), id="launcher-llama"),
    pytest.param((8, 32, 1, 540, 128), (1, 64), id="llama-8-rows"),
    pytest.param((3, 8, 4, 540, 128), (4, 64), id="llama-gqa"),
    pytest.param((4, 8, 12, 552, 192), (2, 32), id="nemotron"),
    pytest.param((4, 1, 8, 552, 256), (8, 32), id="paligemma"),
    pytest.param((4, 1, 16, 2048, 256), (8, 32), id="recurrentgemma"),
    pytest.param((8, 5, 3, 280, 64), (2, 128), id="smollm"),
    pytest.param((8, 2, 8, 280, 128), (4, 64), id="qwen"),
    pytest.param((4, 16, 1, 1500, 64), (2, 128), id="whisper-cross"),
    pytest.param((2, 32, 1, 32768, 128), (2, 64), id="decode-32k"),
]


@pytest.mark.parametrize("shape,want", MAIN_PATH_PLANS)
def test_ring_plan_at_main_path_shapes(shape, want):
    """The library's rule (``chip_smoke.py`` phase 3 checks that the
    library returns these): 32 KB of K and V a stage, and the largest
    cluster that keeps the grid within one CTA an SM, within half the
    partitions."""
    B, K, G, S, hd = shape
    cluster, part, stages = plan(B, K, G, S, hd)
    assert (cluster, part) == want and stages == STAGES
    assert 4 * part * hd <= STAGE_BYTES
    units = B * K * -(-G // MAX_G)
    assert units * cluster <= SMS or cluster == 1
    assert cluster == MAX_CLUSTER or units * cluster * 2 > SMS \
        or 2 * cluster > -(-S // part)
