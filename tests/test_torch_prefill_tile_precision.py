"""The arithmetic of the prefill kernels' bfloat16 tile step
(``csrc/prefill_tile.cuh``, namespace ``rt::tile::wg``), emulated in plain
PyTorch on the CPU and held against the reference's own bf16 arithmetic
and the port's plain versions.

The step takes float32 scores of bf16 operands, walks keys in stages of
``stage_keys(hd, rows)`` (128 where a tile has two consumer warpgroups at
head dim <= 128, else 64) that start at multiples of the stage, rounds
each stage's probabilities to bf16 before the P @ V product, and keeps
the row max, the row sum ``l`` (of the float32 probabilities) and the
accumulator in float32.  Paged prefill may split a tile's walk into
``partitions`` parts of whole stages, each with its own (max, sum,
accumulator), merged by log-sum-exp in float32 and rounded once.  The
Pallas kernels do the same per stage (``p.astype(v_ref.dtype)``,
flash.py:96 and prefill_attn.py:95-96): flash with ``q_block = kv_block =
64`` stages its keys exactly as the 64-key emulation does; paged prefill
stages them per ``s_block`` sub-block of a pool block.  The first cases
keep the first step's 64-key stages; the new ones take the Hopper step's
stages and partitions.

Tolerance, everywhere: max |a - b| <= 2^-7 * max(1, max |b|), the bf16
rule ``chip_smoke.py`` holds the kernels to (``TOL[bfloat16]``).  The
rounding of P costs at most a few bf16 units of the output, so the
emulation must stay inside that budget against the float32 plain
versions; this test checks it before any run on the card.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha
from repro.kernels.paged_prefill.ops import \
    paged_prefill_gqa as jax_paged_prefill
from repro_torch.kernels.flash_attention.ref import flash_ref
from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref

BF16_REL = 2.0 ** -7
STAGE = 64
SMS = 132                     # an H100's SMs


# The kernels' tile and partition rules, which live in the library
# (csrc/prefill_tile.cuh::wg::tile_rows; csrc/paged_prefill.cu::walk and
# partitions), written again as the emulation's oracle.  chip_smoke.py's
# phase 3 holds the library's partition count to the values
# test_tile_and_partition_rules asserts at the same serving shapes.
def tile_rows(hd: int, rows: int, walk: int) -> int:
    """Query-head rows of a tile for a (row, kv head) of ``rows``
    query-head rows whose walk is at most ``walk`` keys."""
    return 128 if rows >= 128 and (hd > 128 or (hd == 128 and walk >= 512)) \
        else 64


def walk_keys(span: int, C: int, window) -> int:
    """The longest walk paged prefill's launcher knows of: the table's
    span, or the window and the chunk."""
    return window + C if window is not None and window + C < span else span


def partitions(B: int, C: int, K: int, G: int, bs: int, MB: int, hd: int,
               window, sms: int = SMS) -> int:
    """Paged prefill's key partitions: 4 where four times the grid fits
    one CTA an SM, fewer where a part would walk under 512 keys."""
    keys = walk_keys(MB * bs, C, window)
    ctas = B * K * -(-C * G // tile_rows(hd, C * G, keys))
    return 1 if ctas * 4 > sms else max(1, min(4, keys // 512))


def stage_keys(hd: int, rows: int, walk: int) -> int:
    """Keys a stage of the Hopper step (``wg::Shape::KT``): 128 where the
    tile has two consumer warpgroups (``tile_rows``) at head dim <= 128,
    else 64."""
    return 128 if tile_rows(hd, rows, walk) == 128 and hd <= 128 else 64


def tile_step_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        ok: torch.Tensor, stage: int = STAGE,
                        parts: int = 1) -> torch.Tensor:
    """q (..., Tq, hd), k and v (..., Tk, hd) in bf16; ok (..., Tq, Tk)
    says which key each query sees.  Stages of ``stage`` keys; with
    ``parts`` > 1 the stages are cut into that many runs of whole stages,
    each folded alone and the runs merged as ``rt::split_kv_merge_row``
    merges them.  Returns (..., Tq, hd) in bf16."""
    hd = q.shape[-1]
    s_all = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    s_all = torch.where(ok, s_all, torch.full_like(s_all, -math.inf))
    shape = q.shape[:-1]
    n = -(-k.shape[-2] // stage)
    runs = []
    for p in range(parts):
        m = torch.full(shape, -math.inf)
        l = torch.zeros(shape)
        acc = torch.zeros(q.shape)
        for i in range(p * n // parts, (p + 1) * n // parts):
            k0 = i * stage
            s = s_all[..., k0:k0 + stage]
            mx = torch.maximum(m, s.amax(dim=-1))
            none = mx == -math.inf             # no live key yet: no rescale
            corr = torch.where(none, torch.ones_like(mx), torch.exp(m - mx))
            base = torch.where(none, torch.zeros_like(mx), mx)
            p_ = torch.exp(s - base[..., None])  # exactly 0 where masked
            l = l * corr + p_.sum(dim=-1)
            acc = acc * corr[..., None] + \
                p_.to(torch.bfloat16).float() @ \
                v[..., k0:k0 + stage, :].float()
            m = mx
        runs.append((m, l, acc))
    if parts == 1:
        m, l, acc = runs[0]
        return (acc / torch.clamp(l, min=1e-30)[..., None]).to(
            torch.bfloat16)
    # the merge: a run that saw no live key (m = -inf) is skipped
    mx = torch.stack([r[0] for r in runs]).amax(dim=0)
    num, den = torch.zeros(q.shape), torch.zeros(shape)
    for m, l, acc in runs:
        w = torch.where((m == -math.inf) | (mx == -math.inf),
                        torch.zeros_like(m), torch.exp(m - mx))
        num = num + w[..., None] * acc
        den = den + w * l
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(torch.bfloat16)


def _bf16(rng, *shape):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _j(t: torch.Tensor):
    """A torch tensor as a JAX array of the same dtype (bf16 exactly)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _err(got: torch.Tensor, want) -> tuple:
    want = torch.from_numpy(np.array(jnp.asarray(want, jnp.float32))) \
        if not isinstance(want, torch.Tensor) else want.float()
    err = float((got.float() - want).abs().max())
    return err, BF16_REL * max(1.0, float(want.abs().max()))


# ----------------------------------------------------------------- flash
def _flash_emulation(q, k, v, window, stage=STAGE):
    """q (B, T, H, hd), k/v (B, T, K, hd), causal, in the model layout."""
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    i = torch.arange(T)
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok = ok & (i[None, :] > i[:, None] - window)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)   # (B, H, T, hd)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    return tile_step_emulation(q.transpose(1, 2), kh, vh, ok,
                               stage).transpose(1, 2)


FLASH_CASES = [
    # B, T, H, K, hd, window
    pytest.param(1, 200, 4, 4, 64, None, id="causal-hd64-T200"),
    pytest.param(1, 130, 8, 2, 128, None, id="gqa-G4-hd128-ragged-T130"),
    pytest.param(2, 150, 2, 2, 64, 48, id="window48-hd64-T150"),
    pytest.param(1, 260, 4, 1, 128, 100, id="gqa-G4-window100-hd128"),
    pytest.param(1, 90, 12, 1, 192, None, id="gqa-G12-hd192-T90"),
]


@pytest.mark.parametrize("B,T,H,K,hd,window", FLASH_CASES)
def test_flash_tile_step_matches_pallas_and_plain(B, T, H, K, hd, window):
    rng = np.random.default_rng(T + H + hd)
    q, k, v = _bf16(rng, B, T, H, hd), _bf16(rng, B, T, K, hd), \
        _bf16(rng, B, T, K, hd)
    emu = _flash_emulation(q, k, v, window)
    # the Pallas kernel in interpret mode, bf16, stages of 64 keys
    pallas = jax_flash_mha(_j(q), _j(k), _j(v), causal=True, window=window,
                           q_block=STAGE, kv_block=STAGE)
    err, tol = _err(emu, pallas)
    assert err <= tol, (err, tol)
    # the port's plain version: float32 on the same bf16 inputs, rounded
    plain = flash_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True,
                      window=window).transpose(1, 2)
    err, tol = _err(emu, plain)
    assert err <= tol, (err, tol)
    # and unrounded
    plain32 = flash_ref(q.float().transpose(1, 2), k.float().transpose(1, 2),
                        v.float().transpose(1, 2), causal=True,
                        window=window).transpose(1, 2)
    err, tol = _err(emu, plain32)
    assert err <= tol, (err, tol)


def test_flash_tile_step_budget_at_serving_length():
    """One row of the launcher's prefill (500 tokens, head dim 128; 8 of
    its 32 heads): the bf16 arithmetic stays inside the tolerance of the
    plain version that chip_smoke.py applies on the card."""
    rng = np.random.default_rng(500)
    q, k, v = (_bf16(rng, 1, 500, 8, 128) for _ in range(3))
    emu = _flash_emulation(q, k, v, None)
    plain = flash_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True).transpose(1, 2)
    err, tol = _err(emu, plain)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("B,T,H,K,hd,window", FLASH_CASES)
def test_flash_hopper_step_matches_pallas_and_plain(B, T, H, K, hd, window):
    """The Hopper step's stages (``stage_keys``: 128 keys at the cases'
    128-row tiles of head dim <= 128) against the Pallas kernel and the
    plain versions."""
    stage = stage_keys(hd, T * (H // K), T if window is None else
                       min(T, window + -(-128 // (H // K))))
    rng = np.random.default_rng(T + H + hd + 1)
    q, k, v = _bf16(rng, B, T, H, hd), _bf16(rng, B, T, K, hd), \
        _bf16(rng, B, T, K, hd)
    emu = _flash_emulation(q, k, v, window, stage)
    pallas = jax_flash_mha(_j(q), _j(k), _j(v), causal=True, window=window,
                           q_block=STAGE, kv_block=STAGE)
    err, tol = _err(emu, pallas)
    assert err <= tol, (err, tol)
    for dt in (torch.bfloat16, torch.float32):
        plain = flash_ref(q.to(dt).transpose(1, 2), k.to(dt).transpose(1, 2),
                          v.to(dt).transpose(1, 2), causal=True,
                          window=window).transpose(1, 2)
        err, tol = _err(emu, plain)
        assert err <= tol, (dt, err, tol)


def test_flash_hopper_step_budget_at_serving_length():
    """The launcher's prefill row (500 tokens, head dim 128, 8 of 32
    heads) in the Hopper step's 128-key stages."""
    rng = np.random.default_rng(501)
    q, k, v = (_bf16(rng, 1, 500, 8, 128) for _ in range(3))
    assert stage_keys(128, 500, 512) == 128
    emu = _flash_emulation(q, k, v, None, 128)
    plain = flash_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True).transpose(1, 2)
    err, tol = _err(emu, plain)
    assert err <= tol, (err, tol)


# --------------------------------------------------------- paged prefill
def _paged_emulation(q, kp, vp, tbl, q_pos, window, stage=STAGE, parts=1):
    """The kernel's walk: logical key positions in stages from 0, each key
    resolved through the table, -1 entries masked; ``parts`` runs of
    stages merged."""
    B, C, H, hd = q.shape
    K, _, bs, _ = kp.shape
    G = H // K
    MB = tbl.shape[1]
    phys = tbl.clamp(min=0).long()
    k = kp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, MB * bs, hd)
    v = vp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, MB * bs, hd)
    t = torch.arange(MB * bs)
    qp = q_pos[:, :, None].long()
    ok = (t[None, None] <= qp) & (tbl[:, t // bs] >= 0)[:, None]
    if window is not None:
        ok = ok & (t[None, None] > qp - window)
    kh = k.repeat_interleave(G, dim=1)                  # (B, H, S, hd)
    vh = v.repeat_interleave(G, dim=1)
    out = tile_step_emulation(q.transpose(1, 2), kh, vh, ok[:, None], stage,
                              parts)
    return out.transpose(1, 2)


PAGED_CASES = [
    # C, K, G, hd, window
    pytest.param(64, 2, 1, 64, None, id="hd64"),
    pytest.param(32, 1, 4, 128, None, id="gqa-G4-hd128"),
    pytest.param(48, 2, 1, 128, 40, id="window40-hd128"),
    pytest.param(16, 1, 12, 192, None, id="gqa-G12-hd192"),
]


def _paged_inputs(rng, C, K, G, hd):
    B, NB, bs, MB = 2, 24, 16, 12
    H = K * G
    kp, vp = _bf16(rng, K, NB, bs, hd), _bf16(rng, K, NB, bs, hd)
    q = _bf16(rng, B, C, H, hd)
    start = np.array([80, 19], np.int32)       # a block boundary; mid-block
    tbl = np.full((B, MB), -1, np.int32)
    tbl[0, :(80 + C - 1) // bs + 1] = rng.permutation(np.arange(1, NB))[
        :(80 + C - 1) // bs + 1]
    tbl[0, 2] = -1                             # a hole in row 0's history
    tbl[1, :(19 + C - 1) // bs + 1] = rng.permutation(np.arange(1, NB))[
        :(19 + C - 1) // bs + 1]
    q_pos = (start[:, None] + np.arange(C)[None]).astype(np.int32)
    return q, kp, vp, tbl, q_pos


def _check_paged(q, kp, vp, tbl, q_pos, window, emu):
    tbl_t, q_pos_t = torch.from_numpy(tbl), torch.from_numpy(q_pos)
    pallas = jax_paged_prefill(_j(q), _j(kp), _j(vp), jnp.asarray(tbl),
                               jnp.asarray(q_pos), window=window,
                               interpret=True)
    err, tol = _err(emu, pallas)
    assert err <= tol, (err, tol)
    plain = paged_prefill_ref(q, kp, vp, tbl_t, q_pos_t, window=window)
    err, tol = _err(emu, plain)
    assert err <= tol, (err, tol)
    plain32 = paged_prefill_ref(q.float(), kp.float(), vp.float(), tbl_t,
                                q_pos_t, window=window)
    err, tol = _err(emu, plain32)
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("C,K,G,hd,window", PAGED_CASES)
def test_paged_prefill_tile_step_matches_pallas_and_plain(C, K, G, hd,
                                                          window):
    rng = np.random.default_rng(C + K + hd)
    q, kp, vp, tbl, q_pos = _paged_inputs(rng, C, K, G, hd)
    emu = _paged_emulation(q, kp, vp, torch.from_numpy(tbl),
                           torch.from_numpy(q_pos), window)
    _check_paged(q, kp, vp, tbl, q_pos, window, emu)


@pytest.mark.parametrize("parts", [1, 2, 3, 4])
@pytest.mark.parametrize("C,K,G,hd,window", PAGED_CASES)
def test_paged_prefill_hopper_partitions_match_pallas_and_plain(
        C, K, G, hd, window, parts):
    """The Hopper step's stages (``stage_keys``) with the walk cut into
    ``parts`` key partitions merged by log-sum-exp (``partitions`` picks 4
    for RecurrentGemma-9B's prefill, phase 9); a run past a row's last
    live key, or wholly before its window, reports -inf and drops out of
    the merge."""
    rng = np.random.default_rng(C + K + hd + parts)
    q, kp, vp, tbl, q_pos = _paged_inputs(rng, C, K, G, hd)
    emu = _paged_emulation(q, kp, vp, torch.from_numpy(tbl),
                           torch.from_numpy(q_pos), window,
                           stage_keys(hd, C * G, walk_keys(12 * 16, C, window)),
                           parts)
    _check_paged(q, kp, vp, tbl, q_pos, window, emu)


def test_tile_and_partition_rules():
    """The library's rules: 128-row tiles where a (row, kv head) has 128
    query-head rows at head dim 192 or 256, or 128 over a walk of 512
    keys or more; key partitions only where four times the grid fits one
    CTA an SM: 4, or fewer where a part would walk under 512 keys."""
    assert [tile_rows(128, r, 4096) for r in (1, 64, 127, 128, 4096)] == \
        [64, 64, 64, 128, 128]
    assert [tile_rows(hd, 512, 512) for hd in (32, 64, 128, 192, 256)] == \
        [64, 64, 128, 128, 128]
    assert [tile_rows(128, 512, w) for w in (150, 511, 512)] == [64, 64, 128]
    assert tile_rows(256, 512, 100) == 128
    assert walk_keys(1024, 64, None) == 1024
    assert walk_keys(1024, 64, 128) == 192
    assert walk_keys(1024, 64, 4096) == 1024
    # phase 3's serving shapes (B 4, C 64, blocks of 16), the values
    # chip_smoke.py holds the library to: Llama-2-7B (G 1 and 4, and a
    # 128-key window; 128 and 64 CTAs), Mixtral-8x22B (G 6, window 4096:
    # 96 CTAs) and Nemotron-4 (G 12, hd 192: 192 CTAs) are not split;
    # RecurrentGemma-9B (1 kv head, G 16, hd 256: 32 CTAs over 2112 keys)
    # is, in 4
    assert partitions(4, 64, 32, 1, 16, 64, 128, None) == 1
    assert partitions(4, 64, 8, 4, 16, 64, 128, None) == 1
    assert partitions(4, 64, 32, 1, 16, 64, 128, 128) == 1
    assert partitions(4, 64, 8, 6, 16, 304, 128, 4096) == 1
    assert partitions(4, 64, 8, 12, 16, 132, 192, None) == 1
    assert partitions(4, 64, 1, 16, 16, 168, 256, 2048) == 4
    # one row of Nemotron (48 CTAs) is not split either; one of
    # RecurrentGemma-9B (8) is
    assert partitions(1, 64, 8, 12, 16, 132, 192, None) == 1
    assert partitions(1, 64, 1, 16, 16, 168, 256, 2048) == 4
    # parts of 512 keys or more: a 992-key span gives one, 1024 two
    assert partitions(4, 64, 1, 16, 16, 62, 256, None) == 1
    assert partitions(4, 64, 1, 16, 16, 64, 256, None) == 2
    for ctas in range(1, 300):
        S = partitions(1, 64, ctas, 1, 16, 1 << 10, 128, None)
        assert S == (4 if 4 * ctas <= SMS else 1)


def test_emulation_rounds_p_not_the_scores():
    """The emulation differs from the float32 plain version only through
    the bf16 rounding of P: with a single live key per row every
    probability is exactly 1 and the two agree bit for bit."""
    rng = np.random.default_rng(1)
    q, k, v = (_bf16(rng, 1, 70, 2, 64) for _ in range(3))
    emu = _flash_emulation(q, k, v, window=1)
    plain = flash_ref(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True,
                      window=1).transpose(1, 2)
    assert torch.equal(emu, plain)
    assert torch.equal(emu, v)
