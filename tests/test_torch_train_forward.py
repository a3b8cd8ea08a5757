"""The port's cache-free training forward (``transformer.forward_train``)
held against the reference's ``forward(cache=None)`` on the CPU, with
bridged weights and the same numpy inputs, one SMOKE config per family:
Llama-2-7B (dense), Nemotron-4-340B (LayerNorm, squared ReLU),
Mixtral-8x22B (MoE aux loss, window 16), RecurrentGemma-9B (REC from the
zero state, window 16), Mamba2-780M (SSD), PaliGemma-3B (image prefix,
prefix-LM mask) and Whisper-medium (encoder over frames, cross-attention).
Then Mixtral's adapter gradients in both MoE dispatch modes (its
scatters under autograd), ``remat=True`` against ``False`` and the plain
attention functions
(``_scores_mask``, ``attention_core``, ``attention_chunked`` with small
chunks and a window) against the reference's.

Every SMOKE model is float32 with one adapter ((D, r) / (r, O) leaves,
the reference's ``init_params(lora_adapters=None)``), its LoRA B and
every bias drawn nonzero so that each shows in the logits.

Tolerances: logits and aux within 1e-5 x max(1, max |reference|) (the two
frameworks contract and reduce in other orders; the largest difference
seen is 3.7e-6, Mamba2); the attention functions within 1e-6 x that;
remat's logits equal bit for bit and its gradients within 1e-6 of each
leaf's largest.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten, _unflatten
from repro.configs import get_smoke as jax_get_smoke
from repro.core.lora import combine_lora as jax_combine
from repro.core.lora import partition_lora as jax_partition
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro.models import transformer as jax_tf
from repro.training import train as jax_train
from repro_torch.checkpoint.bridge import params_from_flat, reference_tree
from repro_torch.checkpoint.store import _flatten as port_flatten
from repro_torch.configs import get_smoke
from repro_torch.core.lora import combine_lora, partition_lora, tree_leaves
from repro_torch.models import layers, moe
from repro_torch.models import transformer as tf
from repro_torch.training import train

FAMILIES = ("llama2_7b", "nemotron_4_340b", "mixtral_8x22b",
            "recurrentgemma_9b", "mamba2_780m", "paligemma_3b",
            "whisper_medium")
TOL = 1e-5
ATTN_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE-sized tensors: one intra-op thread (the test workers share the
    machine's cores); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, tol: float, what: str) -> None:
    want = np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.detach().float().numpy() - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > " \
                               f"{tol * scale:.3e}"


def bridged(cfg_j, cfg_t, seed: int = 0, draw_b: bool = True):
    """(jax params, port params) of one adapter from the reference's
    ``init_params(PRNGKey(seed))``; with ``draw_b`` every LoRA B and bias
    leaf is drawn N(0, 0.1) instead of zero."""
    flat = _flatten(jax_tf.init_params(jax.random.PRNGKey(seed), cfg_j))
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if draw_b and (k.endswith("/b") or k.endswith("/bias")):
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(v.dtype)
    return _unflatten(flat), params_from_flat(flat, cfg_t, device="cpu")


def single_adapter_model(arch: str, seed: int = 0, **cfg_kw):
    """(jax cfg, jax params, port cfg, port params): SMOKE float32, one
    adapter, every LoRA B and bias leaf drawn N(0, 0.1)."""
    cfg_j = jax_get_smoke(arch).with_(dtype="float32", **cfg_kw)
    cfg_t = get_smoke(arch).with_(dtype="float32", **cfg_kw)
    pj, pt = bridged(cfg_j, cfg_t, seed)
    return cfg_j, pj, cfg_t, pt


def extras(cfg, B: int, rng) -> dict:
    """The image prefix (VLM) or the frames (audio) of B rows, as numpy."""
    out = {}
    if cfg.family == "vlm":
        out["embeds"] = (rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(
            np.float32)
    if cfg.family == "audio":
        out["frame_embeds"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_matches_reference(arch):
    """21 tokens (past the SMOKE windows of 16, not a multiple of the scans'
    chunks), two rows: logits of the 21 token positions and the aux
    loss."""
    cfg_j, pj, cfg_t, pt = single_adapter_model(arch)
    assert all(x.dim() == 2 for x in
               tree_leaves(partition_lora(pt)[1]))
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 21)).astype(np.int32)
    ex = extras(cfg_j, 2, rng)
    want, _, aux_j = jax_tf.forward(
        pj, cfg_j, jnp.asarray(toks),
        **{k: jnp.asarray(v) for k, v in ex.items()})
    got, aux_t = tf.forward_train(pt, cfg_t, _t(toks),
                                  **{k: _t(v) for k, v in ex.items()})
    assert got.shape == want.shape == (2, 21, cfg_j.vocab_size)
    _close(got, want, TOL, f"{arch} logits")
    _close(aux_t, aux_j, TOL, f"{arch} aux")
    if arch == "mixtral_8x22b":
        assert float(aux_t) > 0


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "recurrentgemma_9b"])
def test_remat_equals_plain_forward_and_gradients(arch):
    """``remat=True`` recomputes each layer in the backward pass: the same
    logits bit for bit, the same adapter gradients."""
    _, _, cfg, params = single_adapter_model(arch)
    backbone, adapters = partition_lora(params)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 19)).astype(np.int32)
    batch = train.batch_to({"tokens": toks,
                            "labels": np.roll(toks, -1, 1)}, "cpu")
    a, _ = tf.forward_train(params, cfg, batch["tokens"], remat=False)
    b, _ = tf.forward_train(params, cfg, batch["tokens"], remat=True)
    assert torch.equal(a, b)
    grads = {}
    for remat in (False, True):
        loss, _, g = train._value_and_grad(
            cfg, adapters, lambda ad: combine_lora(backbone, ad),
            batch, remat)
        grads[remat] = (loss, tree_leaves(g))
    assert torch.equal(grads[False][0], grads[True][0])
    for x, y in zip(grads[False][1], grads[True][1]):
        assert float((x - y).abs().max()) <= 1e-6 * float(x.abs().max())


@pytest.mark.parametrize("mode", ["ragged", "capacity"])
def test_moe_gradients_match_reference_in_both_dispatch_modes(mode):
    """The MoE's scatters (the dropless combine weights; the capacity
    path's slot buffer and index_add) pass autograd: the adapter
    gradients and the loss of Mixtral SMOKE against the reference's in
    the same dispatch mode, each leaf within 1e-5 of its largest."""
    cfg_j, pj, cfg_t, pt = single_adapter_model("mixtral_8x22b")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg_j.vocab_size, (2, 20)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    try:
        jax_moe.set_dispatch(mode)
        moe.set_dispatch(mode)
        bj, aj = jax_partition(pj)
        (loss_j, _), gj = jax.value_and_grad(
            lambda ad: jax_train.loss_fn(
                jax_combine(bj, ad), cfg_j,
                {k: jnp.asarray(v) for k, v in batch.items()}),
            has_aux=True)(aj)
        bt, at = partition_lora(pt)
        loss_t, _, gt = train._value_and_grad(
            cfg_t, at, lambda ad: combine_lora(bt, ad),
            train.batch_to(batch, "cpu"), True)
    finally:
        jax_moe.set_dispatch("ragged")
        moe.set_dispatch("ragged")
    _close(loss_t, loss_j, TOL, f"{mode} loss")
    want = {k: np.asarray(v) for k, v in _flatten(gj).items()
            if not k.endswith("__empty_tuple__")}
    # the port's per-layer gradients stacked as the reference's periods
    got = {k: v.numpy() for k, v in
           port_flatten(reference_tree(gt, cfg_t)).items()
           if not k.endswith("__empty_tuple__")}
    assert got.keys() == want.keys()
    for k in want:
        scale = float(np.abs(want[k]).max())
        assert scale > 0
        assert float(np.abs(got[k] - want[k]).max()) <= TOL * scale, k


# ------------------------------------------------- plain attention functions
def _qkv(rng, B, Tq, Tk, H, K, hd):
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return r(B, Tq, H, hd), r(B, Tk, K, hd), r(B, Tk, K, hd)


@pytest.mark.parametrize("kind,window,prefix", [
    ("causal", None, 0), ("causal", 5, 0), ("prefix", None, 6),
    ("prefix", 4, 6), ("bidir", None, 0)])
def test_attention_core_and_mask_match_reference(kind, window, prefix):
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 2, 13, 13, 4, 2, 16)
    pos = np.arange(13, dtype=np.int32)[None].repeat(2, 0)
    mask_j = jax_layers._scores_mask(jnp.asarray(pos), jnp.asarray(pos),
                                     kind, window, prefix)
    mask_t = layers._scores_mask(_t(pos), _t(pos), kind, window, prefix)
    assert torch.equal(mask_t, _t(mask_j))
    want = jax_layers.attention_core(*map(jnp.asarray, (q, k, v)), mask_j)
    got = layers.attention_core(_t(q), _t(k), _t(v), mask_t)
    _close(got, want, ATTN_TOL, f"attention_core {kind}")


@pytest.mark.parametrize("kind,window,prefix", [
    ("causal", None, 0), ("causal", 5, 0), ("prefix", 4, 6),
    ("bidir", None, 0)])
def test_attention_chunked_matches_reference(kind, window, prefix):
    """21 queries over 21 keys in chunks of 8 queries x 6 keys (both
    padded), G = 2, positions 1-D and per row."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 2, 21, 21, 4, 2, 16)
    pos = np.arange(21, dtype=np.int32)
    kw = dict(kind=kind, window=window, prefix_len=prefix, q_chunk=8,
              kv_chunk=6)
    for p in (pos, pos[None].repeat(2, 0)):
        want = jax_layers.attention_chunked(
            *map(jnp.asarray, (q, k, v, p, p)), **kw)
        got = layers.attention_chunked(_t(q), _t(k), _t(v), _t(p), _t(p),
                                       **kw)
        _close(got, want, ATTN_TOL, f"attention_chunked {kind}")
        # and the dense function, which the chunks compute
        p2 = _t(pos[None].repeat(2, 0))
        dense = layers.attention_core(
            _t(q), _t(k), _t(v),
            layers._scores_mask(p2, p2, kind, window, prefix))
        _close(got, dense.numpy(), ATTN_TOL, f"chunked vs core {kind}")


def test_forward_train_uses_chunked_attention_past_2048_positions(
        monkeypatch):
    """Past 2048 positions the forward takes ``attention_chunked`` (the
    reference's ``use_chunked = Ttot > 2048``), and at 2048 not."""
    _, _, cfg, params = single_adapter_model("llama2_7b",
                                             num_layers=1)
    calls = []
    real = layers.attention_chunked

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    monkeypatch.setattr(layers, "attention_chunked", spy)
    for T in (2048, 2049):
        tf.forward_train(params, cfg, torch.zeros((1, T), dtype=torch.int32))
    assert calls == [2049]
