"""Whisper-medium in the port, held against the reference (``repro``) on
the CPU with the same numpy inputs and bridged SMOKE weights: the config,
the encoder (``encode``), the GELU MLPs, the cross-attention on ring
caches through ``forward(frame_embeds=)`` and decode, ``make_prefill_step
(frame_embeds=)`` and ``InferenceEngine.generate``, prefill without
frames, the bridge and the launcher's refusal.

Every bias leaf of the bridged checkpoint (LayerNorm ``bias``, LoRA B) is
drawn nonzero, where the reference initialises it to zero, so each one
shows in the outputs.

Tolerances: float32 logits and encoder outputs within atol = rtol = 1e-4
of the reference's (``test_torch_zoo.LOGIT_TOL``: the two frameworks
contract and reduce in other orders); the MLPs in float32 within 1e-5 x
max(1, max |reference|) and in bfloat16 within 2^-7 x that (one rounding
of a float32 intermediate may fall either way); greedy tokens equal.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import contextlib
import io
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_model
from repro.checkpoint.store import _flatten, _unflatten, save_checkpoint
from repro.configs import ARCH_IDS as JAX_IDS
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.core.engine import make_prefill_step as jax_prefill_step
from repro.core.engine import make_serve_step as jax_serve_step
from repro.launch import serve as jax_serve
from repro.models import cache as jax_cache
from repro.models import layers as jax_layers
from repro.models import transformer as jax_tf
from repro_torch.checkpoint.bridge import load_params, params_from_flat
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.engine import InferenceEngine, make_prefill_step
from repro_torch.launch import serve
from repro_torch.models import cache as cache_lib
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from test_torch_zoo import LOGIT_TOL, _bias_leaf, _close, _np, _same_fields, \
    _t

ARCH = "whisper_medium"
# the reference's steps, jitted once for the module (the config is static)
_forward_j = jax.jit(jax_tf.forward, static_argnums=1)
_decode_j = jax.jit(jax_tf.decode_step, static_argnums=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE-sized tensors: one intra-op thread (the test workers share the
    machine's cores); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, torch cfg, torch params): Whisper SMOKE in
    float32 (2 decoder + 2 encoder layers, d_model 128, 4 heads x 32, 16
    frames) with a 3-adapter bank, every bias leaf drawn nonzero."""
    cfg_j, params = build_model(ARCH)
    flat = _flatten(params)
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if _bias_leaf(k):
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
    cfg_t = get_smoke(ARCH).with_(dtype="float32")
    return (cfg_j, _unflatten(flat), cfg_t,
            params_from_flat(flat, cfg_t, device="cpu"))


def _frames(B, seed, n=16, d=128):
    """B rows of n random frame embeddings (the reference's stub
    frontend)."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, d)).astype(np.float32)


def _toks(B, T, seed, vocab=512):
    rng = np.random.default_rng(seed)
    return rng.integers(0, vocab, (B, T)).astype(np.int32)


# ----------------------------------------------------------------- config
def test_config_and_param_count_equal_the_reference():
    assert ARCH in ARCH_IDS and ARCH_IDS.index(ARCH) == JAX_IDS.index(ARCH)
    assert get_config(ARCH) == _same_fields(jax_get_config(ARCH))
    assert get_smoke(ARCH) == _same_fields(jax_get_smoke(ARCH))
    assert get_config(ARCH).param_count() == 810_863_616
    assert get_smoke(ARCH).param_count() == jax_get_smoke(ARCH).param_count()


def test_paging_unsupported_reason_equals_the_reference():
    for cfg_t, cfg_j in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_smoke(ARCH), jax_get_smoke(ARCH))):
        reason = cache_lib.paging_unsupported_reason(cfg_t)
        assert reason is not None
        assert reason == jax_cache.paging_unsupported_reason(cfg_j)
    with pytest.raises(ValueError, match="encoder/cross-attention"):
        cache_lib.init_paged_cache(get_smoke(ARCH), 8, 8, device="cpu")


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlps_match_reference(dtype):
    """The decoder's GELU ``apply_mlp`` and ``apply_encoder_mlp``: the
    tanh approximation of ``jax.nn.gelu``, not torch's erf GELU."""
    cfg_j = jax_get_smoke(ARCH).with_(dtype=dtype)
    cfg_t = get_smoke(ARCH).with_(dtype=dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    rng = np.random.default_rng(2)
    D, F = cfg_t.d_model, cfg_t.d_ff
    x = jnp.asarray(rng.standard_normal((2, 7, D)) * 2, jdt)
    p = {"wi": {"w": jnp.asarray(rng.standard_normal((D, F)) / np.sqrt(D),
                                 jdt)},
         "wo": {"w": jnp.asarray(rng.standard_normal((F, D)) / np.sqrt(F),
                                 jdt)}}
    pt = {k: {"w": _t(v["w"])} for k, v in p.items()}
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    _close(layers.apply_mlp(pt, cfg_t, _t(x)),
           jax_layers.apply_mlp(p, cfg_j, x), tol, "gelu mlp")
    _close(layers.apply_encoder_mlp(pt, _t(x)),
           jax_layers.apply_encoder_mlp(p, x), tol, "encoder mlp")
    # torch's default (erf) GELU is a different function at this tolerance
    erf = torch.nn.functional.gelu(_t(x) @ pt["wi"]["w"]) @ pt["wo"]["w"]
    with pytest.raises(AssertionError):
        _close(erf, jax_layers.apply_encoder_mlp(p, x), 1e-5, "erf")


def test_encode_matches_reference(model):
    """The bidirectional encoder (RoPE at [0, T), every key visible, GELU
    MLP, final LayerNorm) over 16 random frames, two rows."""
    cfg_j, pj, cfg_t, pt = model
    fr = _frames(2, 1)
    want = jax_tf.encode(pj, cfg_j, jnp.asarray(fr))
    got = tf.encode(pt, cfg_t, _t(fr))
    assert tuple(got.shape) == (2, cfg_t.encoder_seq, cfg_t.d_model)
    np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL)


# --------------------------------------------------------------- the stack
def _ring_run(cfg_j, pj, cfg_t, pt, toks, steps, ai, frames=None,
              ct=None):
    """Prefill (over ``frames`` where given) and ``steps`` greedy decode
    steps in both packages, the port on ``ct`` (a fresh ring if None);
    returns each call's (port, reference) logits and both caches."""
    B, T = toks.shape
    ctx = T + steps + 3
    cj = jax_cache.init_cache(cfg_j, B, ctx)
    ct = tf.init_cache(cfg_t, B, ctx, device="cpu") if ct is None else ct
    kw_j = {"adapter_idx": jnp.asarray(ai)}
    kw_t = {"adapter_idx": _t(ai)}
    fj = {} if frames is None else {"frame_embeds": jnp.asarray(frames)}
    ft = {} if frames is None else {"frame_embeds": _t(frames)}
    lj, cj, _ = _forward_j(pj, cfg_j, jnp.asarray(toks), cache=cj, **fj,
                           **kw_j)
    lt, ct = tf.forward(pt, cfg_t, _t(toks), cache=ct, **ft, **kw_t)
    out = [(lt, lj)]
    tok = np.asarray(lj)[:, -1].argmax(-1).astype(np.int32)
    for i in range(steps):
        dj, cj = _decode_j(pj, cfg_j, jnp.asarray(tok), cj,
                           jnp.asarray(T + i, jnp.int32), **kw_j)
        dt, ct = tf.decode_step(pt, cfg_t, _t(tok), ct, T + i, **kw_t)
        out.append((dt, dj))
        tok = np.asarray(dj).argmax(-1).astype(np.int32)
    return out, cj, ct


def test_ring_forward_with_frames_and_decode_match_reference(model):
    """Prefill of 11 tokens over 16 frames and 4 decode steps, two rows on
    two adapters: every logit within 1e-4 of the reference's, and each
    layer's cross cache equal to the reference's ``xk`` / ``xv``."""
    cfg_j, pj, cfg_t, pt = model
    runs, cj, ct = _ring_run(cfg_j, pj, cfg_t, pt, _toks(2, 11, 5), 4,
                             np.array([1, 2], np.int32), frames=_frames(2, 6))
    assert tuple(runs[0][0].shape) == (2, 11, cfg_t.vocab_size)
    for i, (got, want) in enumerate(runs):
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL,
                                   err_msg=f"step {i}")
    for n, layer in enumerate(ct):
        for name in ("xk", "xv"):
            want = np.asarray(cj["periods"]["p0"][name][n])
            np.testing.assert_allclose(_np(layer[name]), want, **LOGIT_TOL)
        assert layer["xpos"].tolist() == list(range(cfg_t.encoder_seq))


def test_prefill_step_and_generate_match_reference_loop(model):
    """``make_prefill_step(frame_embeds=)``'s last-position logits, then
    ``InferenceEngine.generate(frame_embeds=)``: the greedy tokens of the
    reference's ``make_prefill_step`` + ``make_serve_step`` loop, three
    rows on three adapters, 6 new tokens."""
    cfg_j, pj, cfg_t, pt = model
    B, T, new = 3, 9, 6
    toks, fr = _toks(B, T, 7), _frames(B, 8)
    ai = np.array([2, 0, 1], np.int32)
    ctx = T + new + 4
    lj, cj = jax.jit(jax_prefill_step(cfg_j))(
        pj, jnp.asarray(toks), jax_cache.init_cache(cfg_j, B, ctx),
        frame_embeds=jnp.asarray(fr), adapter_idx=jnp.asarray(ai))
    lt, _ = make_prefill_step(cfg_t)(
        pt, _t(toks), tf.init_cache(cfg_t, B, ctx, device="cpu"),
        frame_embeds=_t(fr), adapter_idx=_t(ai))
    np.testing.assert_allclose(_np(lt), np.asarray(lj), **LOGIT_TOL)

    serve_j = jax.jit(jax_serve_step(cfg_j))
    tok = jnp.argmax(lj, -1).astype(jnp.int32)
    want = [np.asarray(tok)]
    for i in range(new - 1):
        logits, cj = serve_j(pj, tok, cj, jnp.asarray(T + i, jnp.int32),
                             adapter_idx=jnp.asarray(ai))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        want.append(np.asarray(tok))
    eng = InferenceEngine(cfg_t, pt, max_context=ctx, device="cpu")
    got, cache = eng.generate(_t(toks), new, _t(ai), frame_embeds=_t(fr))
    assert got.tolist() == np.stack(want, axis=1).tolist()
    assert eng.captures() == {(B, ctx): 1}
    assert cache[0]["idx"] == T + new - 1


@pytest.mark.parametrize("ring", ["fresh", "reused"])
def test_prefill_without_frames_matches_reference(model, ring):
    """A prefill with no frames skips cross-attention and leaves the cross
    cache zero; decode then attends over those zeros, as the reference's
    does.  "reused": the engine's ring of this batch size after a
    ``generate`` over frames, emptied by ``ring()``."""
    cfg_j, pj, cfg_t, pt = model
    toks, ai = _toks(2, 10, 9), np.array([0, 2], np.int32)
    ct = None
    if ring == "reused":
        eng = InferenceEngine(cfg_t, pt, max_context=10 + 3 + 3,
                              device="cpu")
        eng.generate(_t(toks), 3, _t(ai), frame_embeds=_t(_frames(2, 10)))
        ct, _ = eng.ring(2)
    runs, _, ct = _ring_run(cfg_j, pj, cfg_t, pt, toks, 3, ai, ct=ct)
    for layer in ct:
        assert not layer["xk"].any() and not layer["xv"].any()
    for i, (got, want) in enumerate(runs):
        np.testing.assert_allclose(_np(got), np.asarray(want), **LOGIT_TOL,
                                   err_msg=f"{ring} ring, step {i}")


def test_frames_of_another_length_are_refused(model):
    """The cross cache is preallocated at ``encoder_seq`` (a captured
    decode step reads it at fixed addresses), so frames of another length
    raise, where the reference rebinds its cache to their length."""
    _, _, cfg_t, pt = model
    toks = _t(_toks(2, 5, 11))
    for n in (cfg_t.encoder_seq - 1, cfg_t.encoder_seq + 1):
        cache = tf.init_cache(cfg_t, 2, 12, device="cpu")
        with pytest.raises(ValueError, match="encoder_seq"):
            tf.forward(pt, cfg_t, toks, cache=cache,
                       frame_embeds=_t(_frames(2, 12, n=n)))
        assert cache[0]["idx"] == 0 and not cache[0]["xk"].any()


# ------------------------------------------------------------------ bridge
def test_whisper_checkpoint_crosses_the_bridge(model, tmp_path):
    """The SMOKE weights in bf16, written by the reference's
    ``save_checkpoint``: every encoder leaf (stacked over its layers), the
    encoder's norm and each decoder layer's ``normx`` / ``xattn`` arrive
    equal, leaf for leaf."""
    cfg = jax_get_smoke(ARCH)
    flat = {k: jnp.asarray(v, jnp.bfloat16)
            for k, v in _flatten(model[1]).items()}
    path = str(tmp_path / ARCH)
    save_checkpoint(path, _unflatten(flat))
    got = load_params(path, get_smoke(ARCH), device="cpu",
                      dtype=torch.bfloat16)
    enc = got["encoder"]
    assert len(enc["layers"]) == cfg.encoder_layers
    checked = 0
    for key, val in flat.items():
        parts = key.split("/")
        if parts[:2] == ["encoder", "layers"]:
            trees = [(enc["layers"][n], val[n])
                     for n in range(cfg.encoder_layers)]
            parts = parts[2:]
        elif parts[0] == "encoder":
            trees, parts = [(enc, val)], parts[1:]
        elif parts[0] == "periods" and parts[2] in ("normx", "xattn"):
            trees = [(got["layers"][n], val[n])
                     for n in range(cfg.num_layers)]
            parts = parts[2:]
        else:
            continue
        for tree, want in trees:
            for part in parts:
                tree = tree[part]
            assert tree.dtype == torch.bfloat16
            assert torch.equal(tree, _t(want)), key
            checked += 1
    # 2 encoder layers x 10 leaves (2 norms of 2, 4 projections, wi, wo),
    # the encoder norm's 2, 2 decoder layers x (normx's 2 + xattn's 4)
    assert checked == 2 * 10 + 2 + 2 * 6
    assert "lora" not in got["layers"][0]["xattn"]
    assert "lora" not in enc["layers"][0]["attn"]


# ---------------------------------------------------------------- launcher
def test_launcher_refuses_whisper_as_the_reference_does():
    """``--arch whisper_medium`` is a valid choice of both launchers, and
    both refuse it with the same ``SystemExit``."""
    argv = sys.argv
    sys.argv = ["serve", "--arch", ARCH]
    try:
        with pytest.raises(SystemExit) as ref, \
                contextlib.redirect_stdout(io.StringIO()):
            jax_serve.main()
    finally:
        sys.argv = argv
    with pytest.raises(SystemExit) as got:
        serve.main(["--arch", ARCH, "--device", "cpu"])
    assert str(got.value) == str(ref.value)
    assert "decoder-only" in str(got.value)
