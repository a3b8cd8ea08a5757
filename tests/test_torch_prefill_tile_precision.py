"""The arithmetic of the prefill kernels' bfloat16 tile step
(``csrc/prefill_tile.cuh``, namespace ``rt::tile::tc``), emulated in plain
PyTorch on the CPU and held against the reference's own bf16 arithmetic
and the port's plain versions.

The tensor-core step takes float32 scores of bf16 operands, walks keys in
stages of 64 that start at multiples of 64, rounds each stage's
probabilities to bf16 before the P @ V product, and keeps the row max,
the row sum ``l`` (of the float32 probabilities) and the accumulator in
float32.  The Pallas kernels do the same (``p.astype(v_ref.dtype)``,
flash.py:96 and prefill_attn.py:95-96): flash with ``q_block = kv_block =
64`` stages its keys exactly as the emulation does; paged prefill stages
them per ``s_block`` sub-block of a pool block.

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


def tile_step_emulation(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        ok: torch.Tensor) -> torch.Tensor:
    """q (..., Tq, hd), k and v (..., Tk, hd) in bf16; ok (..., Tq, Tk)
    says which key each query sees.  Returns (..., Tq, hd) in bf16."""
    hd = q.shape[-1]
    s_all = (q.float() @ k.float().transpose(-1, -2)) / math.sqrt(hd)
    s_all = torch.where(ok, s_all, torch.full_like(s_all, -math.inf))
    shape = q.shape[:-1]
    m = torch.full(shape, -math.inf)
    l = torch.zeros(shape)
    acc = torch.zeros(q.shape)
    for k0 in range(0, k.shape[-2], STAGE):
        s = s_all[..., k0:k0 + STAGE]
        mx = torch.maximum(m, s.amax(dim=-1))
        none = mx == -math.inf                 # no live key yet: no rescale
        corr = torch.where(none, torch.ones_like(mx), torch.exp(m - mx))
        base = torch.where(none, torch.zeros_like(mx), mx)
        p = torch.exp(s - base[..., None])     # exactly 0 where masked
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + \
            p.to(torch.bfloat16).float() @ v[..., k0:k0 + STAGE, :].float()
        m = mx
    return (acc / torch.clamp(l, min=1e-30)[..., None]).to(torch.bfloat16)


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
def _flash_emulation(q, k, v, window):
    """q (B, T, H, hd), k/v (B, T, K, hd), causal, in the model layout."""
    B, T, H, hd = q.shape
    G = H // k.shape[2]
    i = torch.arange(T)
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok = ok & (i[None, :] > i[:, None] - window)
    kh = k.transpose(1, 2).repeat_interleave(G, dim=1)   # (B, H, T, hd)
    vh = v.transpose(1, 2).repeat_interleave(G, dim=1)
    return tile_step_emulation(q.transpose(1, 2), kh, vh, ok).transpose(1, 2)


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


# --------------------------------------------------------- paged prefill
def _paged_emulation(q, kp, vp, tbl, q_pos, window):
    """The kernel's walk: logical key positions in stages from 0, each key
    resolved through the table, -1 entries masked."""
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
    out = tile_step_emulation(q.transpose(1, 2), kh, vh, ok[:, None])
    return out.transpose(1, 2)


PAGED_CASES = [
    # C, K, G, hd, window
    pytest.param(64, 2, 1, 64, None, id="hd64"),
    pytest.param(32, 1, 4, 128, None, id="gqa-G4-hd128"),
    pytest.param(48, 2, 1, 128, 40, id="window40-hd128"),
    pytest.param(16, 1, 12, 192, None, id="gqa-G12-hd192"),
]


@pytest.mark.parametrize("C,K,G,hd,window", PAGED_CASES)
def test_paged_prefill_tile_step_matches_pallas_and_plain(C, K, G, hd,
                                                          window):
    rng = np.random.default_rng(C + K + hd)
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
    tbl_t, q_pos_t = torch.from_numpy(tbl), torch.from_numpy(q_pos)
    emu = _paged_emulation(q, kp, vp, tbl_t, q_pos_t, window)
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
