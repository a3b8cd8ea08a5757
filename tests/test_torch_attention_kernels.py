"""The port's flash and ring-decode attention wrappers on the CPU (their
plain PyTorch versions) against the reference's Pallas kernels in
interpret mode, its jnp oracles and the model's own attention functions,
on the same numpy inputs.

Tolerances: float32, atol = rtol = 1e-5 — the implementations differ only
in summation order.  bfloat16: max |port - reference| <= 2^-7 * max(1,
max |reference|) — both compute in float32 and round once to bfloat16, so
they may land one unit (2^-8 relative) apart; 2^-7 allows two (the rule
chip_smoke.py holds the kernels to).  Every compared row keeps at least one
key: the reference averages every key of a row that keeps none, the port
returns zeros, and no caller has such a row.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_gqa as jax_decode_gqa
from repro.kernels.decode_attention.ref import \
    decode_attention_ref as jax_decode_ref
from repro.kernels.flash_attention.ops import flash_mha as jax_flash_mha
from repro.kernels.flash_attention.ref import flash_ref as jax_flash_ref
from repro.models.layers import _scores_mask, attention_chunked, \
    attention_core
from repro_torch import kernels
from repro_torch.kernels.decode_attention.ops import decode_gqa
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.flash_attention.ref import flash_ref

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_REL = 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(a)


def _assert_bf16_close(got: torch.Tensor, want) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_REL * max(1.0, np.abs(want).max()), err


# ----------------------------------------------------------------- flash
FLASH_CASES = [
    # B, Tq, Tk, H, K, causal, window
    pytest.param(2, 64, 64, 2, 2, True, None, id="causal-G1"),
    pytest.param(1, 40, 40, 4, 2, True, None, id="causal-G2-T40"),
    pytest.param(2, 100, 100, 4, 1, True, None, id="causal-G4-T100"),
    pytest.param(2, 24, 32, 4, 2, False, None, id="noncausal-unpadded-Tk"),
    pytest.param(1, 40, 40, 4, 2, True, 8, id="causal-window8"),
    pytest.param(2, 70, 70, 2, 1, True, 33, id="causal-window33-T70"),
    pytest.param(1, 32, 32, 2, 2, False, 8, id="noncausal-window8"),
]


def _flash_inputs(B, Tq, Tk, H, K, hd=32, seed=0):
    rng = np.random.default_rng(seed + Tq * 7 + H)
    q = rng.standard_normal((B, Tq, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, Tk, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, Tk, K, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,Tq,Tk,H,K,causal,window", FLASH_CASES)
def test_flash_matches_pallas_and_oracle(B, Tq, Tk, H, K, causal, window):
    q, k, v = _flash_inputs(B, Tq, Tk, H, K)
    before = flash_mha.launches
    got = flash_mha(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert flash_mha.launches == before      # the CPU takes the plain path
    assert got.shape == (B, Tq, H, q.shape[-1])
    # interpret-mode Pallas through the reference's wrapper; kv blocks of
    # 16 divide every Tk here, so its unmasked kv padding never arises
    pallas = jax_flash_mha(_j(q), _j(k), _j(v), causal=causal,
                           window=window, q_block=16, kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    tr = (0, 2, 1, 3)
    oracle = jax_flash_ref(_j(q.transpose(tr)), _j(k.transpose(tr)),
                           _j(v.transpose(tr)), causal=causal,
                           window=window)
    mine = flash_ref(_t(q.transpose(tr)), _t(k.transpose(tr)),
                     _t(v.transpose(tr)), causal=causal, window=window)
    np.testing.assert_allclose(mine.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("B,Tq,Tk,H,K,causal,window", FLASH_CASES)
def test_flash_matches_model_attention(B, Tq, Tk, H, K, causal, window):
    """The model's dense path (``attention_core``) and its chunked path
    (``attention_chunked``, taken for T > 2048; here with 8-wide chunks so
    a small T crosses many of them) compute the same function."""
    q, k, v = _flash_inputs(B, Tq, Tk, H, K, seed=1)
    got = flash_mha(_t(q), _t(k), _t(v), causal=causal, window=window)
    kind = "causal" if causal else "bidir"
    qpos, kpos = jnp.arange(Tq), jnp.arange(Tk)
    mask = _scores_mask(jnp.broadcast_to(qpos, (B, Tq)),
                        jnp.broadcast_to(kpos, (B, Tk)), kind, window)
    core = attention_core(_j(q), _j(k), _j(v), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(core), **TOL)
    chunked = attention_chunked(_j(q), _j(k), _j(v), qpos, kpos, kind=kind,
                                window=window, q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(chunked), **TOL)


def test_flash_bfloat16_within_one_rounding():
    q, k, v = _flash_inputs(2, 40, 40, 4, 2)
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = flash_mha(qb, kb, vb, causal=True, window=16)
    assert got.dtype == torch.bfloat16
    tr = (0, 2, 1, 3)
    jb = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16).transpose(tr)
          for x in (qb, kb, vb)]
    want = jax_flash_ref(*jb, causal=True, window=16).transpose(tr)
    _assert_bf16_close(got, want)


OFFSET_CASES = [
    # B, T, H, K, q0, t, window, prefix_len, keys: "all" T or "upto" the
    # chunk's last query (or the prefix's end), as the sharded prefill
    pytest.param(2, 64, 4, 2, 16, 16, None, 0, "all", id="causal"),
    pytest.param(1, 70, 4, 1, 33, 21, None, 0, "upto", id="causal-odd-upto"),
    pytest.param(2, 64, 2, 1, 40, 24, 16, 0, "all", id="window16"),
    pytest.param(1, 72, 4, 2, 48, 24, 20, 0, "upto", id="window20-upto"),
    pytest.param(1, 48, 4, 2, 8, 16, None, 20, "upto", id="prefix-inside"),
    pytest.param(2, 48, 4, 2, 24, 24, 12, 30, "all", id="prefix-window"),
]


@pytest.mark.parametrize("B,T,H,K,q0,t,window,prefix,keys", OFFSET_CASES)
def test_flash_query_offset_equals_rows_of_the_whole(B, T, H, K, q0, t,
                                                     window, prefix, keys):
    """``q_offset``: the queries [q0, q0 + t) of a length-T sequence over
    its keys (all T, or those up to the chunk's last query or the
    prefix's end) equal rows [q0, q0 + t) of the reference's attention
    over the whole sequence: its ``flash_ref`` and its Pallas
    ``flash_mha`` in interpret mode, or, behind a prefix, which those
    lack, ``attention_core`` under ``_scores_mask(kind="prefix")``; the
    port's ``flash_ref`` likewise.  float32 within 1e-5."""
    q, k, v = _flash_inputs(B, T, T, H, K, seed=2)
    n = T if keys == "all" else max(q0 + t, prefix)
    kw = dict(causal=True, window=window, prefix_len=prefix, q_offset=q0)
    got = flash_mha(_t(q[:, q0:q0 + t]), _t(k[:, :n]), _t(v[:, :n]), **kw)
    tr = (0, 2, 1, 3)
    mine = flash_ref(_t(q[:, q0:q0 + t].transpose(tr)),
                     _t(k[:, :n].transpose(tr)), _t(v[:, :n].transpose(tr)),
                     **kw).transpose(1, 2)
    if prefix:
        pos = jnp.broadcast_to(jnp.arange(T), (B, T))
        mask = _scores_mask(pos, pos, "prefix", window, prefix)
        wants = [attention_core(_j(q), _j(k), _j(v), mask)]
    else:
        wants = [jax_flash_ref(_j(q.transpose(tr)), _j(k.transpose(tr)),
                               _j(v.transpose(tr)), causal=True,
                               window=window).transpose(tr),
                 jax_flash_mha(_j(q), _j(k), _j(v), causal=True,
                               window=window, q_block=16, kv_block=16)]
    for want in wants:
        want = np.asarray(want)[:, q0:q0 + t]
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        np.testing.assert_allclose(mine.numpy(), want, **TOL)


@pytest.mark.parametrize("bad", ["kv_heads", "window", "empty_keys",
                                 "negative_q_offset", "q_offset_past_keys"])
def test_flash_rejects_bad_shapes(bad):
    q, k, v = (_t(x) for x in _flash_inputs(1, 8, 8, 4, 2))
    kw = {}
    if bad == "kv_heads":
        k = v = k[:, :, :1].repeat(1, 1, 3, 1)      # 4 % 3 != 0
    elif bad == "window":
        kw["window"] = 0
    elif bad == "negative_q_offset":
        kw["q_offset"] = -1
    elif bad == "q_offset_past_keys":                # causal: 1 + 8 > 8
        kw["q_offset"] = 1
    else:
        k = v = k[:, :0]
    with pytest.raises(ValueError):
        flash_mha(q, k, v, **kw)


# ---------------------------------------------------------------- decode
def _ring(S, written):
    """slot_pos of a ring of S slots after ``written`` tokens at positions
    0..written-1 (slot = position % S)."""
    sp = np.full(S, -1, np.int32)
    for p in range(written):
        sp[p % S] = p
    return sp


DECODE_CASES = [
    # B, S, H, K, written, window, s_block
    pytest.param(2, 64, 4, 2, 40, None, 16, id="partly-filled"),
    pytest.param(2, 48, 4, 2, 70, None, 16, id="wrapped"),
    pytest.param(1, 48, 4, 2, 70, 20, 16, id="wrapped-window"),
    pytest.param(2, 32, 4, 1, 25, None, 16, id="gqa-G4"),
    pytest.param(1, 768, 2, 1, 700, None, 512, id="S768-block512"),
]


def _decode_inputs(B, S, H, K, hd=32, seed=0):
    rng = np.random.default_rng(seed + S + H)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("B,S,H,K,written,window,s_block", DECODE_CASES)
def test_ring_decode_matches_pallas_and_oracle(B, S, H, K, written, window,
                                               s_block):
    q, k, v = _decode_inputs(B, S, H, K)
    sp = _ring(S, written)
    pos = written - 1
    before = decode_gqa.launches
    got = decode_gqa(_t(q), _t(k), _t(v), _t(sp), pos, window=window)
    assert decode_gqa.launches == before
    got_t = decode_gqa(_t(q), _t(k), _t(v), _t(sp),
                       torch.tensor(pos, dtype=torch.int32), window=window)
    np.testing.assert_array_equal(got.numpy(), got_t.numpy())
    pallas = jax_decode_gqa(_j(q), _j(k), _j(v), _j(sp),
                            jnp.asarray(pos, jnp.int32), window=window,
                            s_block=s_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    oracle = jax_decode_ref(_j(q), _j(k), _j(v), _j(sp),
                            jnp.asarray(pos, jnp.int32), window=window)
    mine = decode_attention_ref(_t(q), _t(k), _t(v), _t(sp), pos,
                                window=window)
    np.testing.assert_allclose(mine.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("B,S,H,K,written,window,s_block", DECODE_CASES)
def test_ring_decode_lse_merges_halves_to_pallas(B, S, H, K, written, window,
                                                 s_block):
    """``return_lse``: the log of the sum of exp scores over the valid
    slots, against numpy's; the two halves of the ring attended apart and
    merged by their lse (as ``layers._merge_partials`` merges ranks) equal
    the reference's Pallas kernel over the whole ring."""
    q, k, v = _decode_inputs(B, S, H, K)
    sp = _ring(S, written)
    pos = written - 1
    out, lse = decode_gqa(_t(q), _t(k), _t(v), _t(sp), pos, window=window,
                          return_lse=True)
    np.testing.assert_array_equal(
        out.numpy(), decode_gqa(_t(q), _t(k), _t(v), _t(sp), pos,
                                window=window).numpy())
    ok = (sp >= 0) & (sp <= pos)
    if window is not None:
        ok &= sp > pos - window
    G = H // K
    qg = q.reshape(B, K, G, -1).astype(np.float64)
    sc = np.einsum("bkgh,bskh->bkgs", qg, k.astype(np.float64)) \
        / np.sqrt(q.shape[-1])
    sc = np.where(ok, sc, -np.inf)
    m = sc.max(-1)
    want = (m + np.log(np.exp(sc - m[..., None]).sum(-1))).reshape(B, H)
    np.testing.assert_allclose(lse.numpy(), want, **TOL)
    h = S // 2
    parts = [decode_gqa(_t(q), _t(k[:, a:b].copy()), _t(v[:, a:b].copy()),
                        _t(sp[a:b].copy()), pos, window=window,
                        return_lse=True) for a, b in ((0, h), (h, S))]
    top = torch.maximum(parts[0][1], parts[1][1])
    w = [torch.exp(l_ - top)[..., None] for _, l_ in parts]
    merged = (w[0] * parts[0][0] + w[1] * parts[1][0]) / (w[0] + w[1])
    pallas = jax_decode_gqa(_j(q), _j(k), _j(v), _j(sp),
                            jnp.asarray(pos, jnp.int32), window=window,
                            s_block=s_block)
    np.testing.assert_allclose(merged.numpy(), np.asarray(pallas), **TOL)


def test_ring_decode_ignores_future_and_empty_slots():
    """Slots holding positions past ``pos`` (a stale lap of the ring) and
    empty slots get probability exactly 0."""
    q, k, v = _decode_inputs(1, 16, 2, 1)
    sp = _ring(16, 10)
    sp[12] = 99                                   # a position in the future
    base = decode_gqa(_t(q), _t(k), _t(v), _t(sp), 9)
    k2, v2 = k.copy(), v.copy()
    k2[:, 10:] = 1e3                              # never attended
    v2[:, 10:] = -1e3
    again = decode_gqa(_t(q), _t(k2), _t(v2), _t(sp), 9)
    np.testing.assert_array_equal(base.numpy(), again.numpy())


def test_ring_decode_bfloat16_within_one_rounding():
    q, k, v = _decode_inputs(2, 48, 4, 2)
    sp = _ring(48, 70)
    qb, kb, vb = (_t(x).to(torch.bfloat16) for x in (q, k, v))
    got = decode_gqa(qb, kb, vb, _t(sp), 69, window=30)
    assert got.dtype == torch.bfloat16
    jb = [jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
          for x in (qb, kb, vb)]
    _assert_bf16_close(got, jax_decode_ref(*jb, _j(sp),
                                           jnp.asarray(69, jnp.int32),
                                           window=30))


@pytest.mark.parametrize("bad", ["slot_pos", "pos", "window"])
def test_ring_decode_rejects_bad_shapes(bad):
    q, k, v = (_t(x) for x in _decode_inputs(1, 8, 2, 1))
    sp, pos, kw = _t(_ring(8, 5)), 4, {}
    if bad == "slot_pos":
        sp = sp[:7]
    elif bad == "pos":
        pos = torch.tensor([4], dtype=torch.int32)
    else:
        kw["window"] = -1
    with pytest.raises(ValueError):
        decode_gqa(q, k, v, sp, pos, **kw)


# ------------------------------------------------------------- dispatch
def test_registry_counts_both_kernels():
    assert {"flash_attention", "decode_attention"} <= set(
        kernels.KERNEL_REGISTRY)
    assert kernels.get_kernel("flash_attention") is flash_mha
    assert kernels.get_kernel("decode_attention") is decode_gqa
    flash_mha.launches = decode_gqa.launches = 7
    kernels.reset_launches()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == counts["decode_attention"] == 0


@pytest.mark.parametrize("name", ["flash", "decode"])
def test_tensors_off_the_cpu_never_take_the_plain_version(name, monkeypatch):
    """Kernel or raise: a tensor that is not on the CPU never reaches the
    plain version.  All-meta inputs (the dry run) give an output of the
    kernel's shape and record the kernel's work, computing nothing; a mix
    of devices raises."""
    import repro_torch.kernels.decode_attention.ops as dops
    import repro_torch.kernels.flash_attention.ops as fops
    from repro_torch.kernels import cuda_lib

    def plain(*a, **k):
        raise AssertionError("the plain version ran")

    monkeypatch.setattr(fops, "flash_ref", plain)
    monkeypatch.setattr(dops, "decode_attention_ref", plain)
    if name == "flash":
        q, k, v = (torch.empty(s, device="meta")
                   for s in ((1, 8, 2, 32), (1, 8, 2, 32), (1, 8, 2, 32)))
        call = lambda q=q: flash_mha(q, k, v)                # noqa: E731
    else:
        q = torch.empty((1, 2, 32), device="meta")
        k = v = torch.empty((1, 8, 2, 32), device="meta")
        sp = torch.empty((8,), dtype=torch.int32, device="meta")
        call = lambda q=q: decode_gqa(q, k, v, sp, 3)        # noqa: E731
    with cuda_lib.record_work() as work:
        out = call()
    assert out.device.type == "meta" and out.shape == q.shape
    assert len(work) == 1 and work[0][1].flops > 0
    with pytest.raises(ValueError, match="devices"):
        call(torch.empty(q.shape))
