"""The port's REC (RG-LRU) and SSD (Mamba-2) layers and the hybrid and
attention-free SMOKE stacks against the reference (``repro.models``) on
the same numpy inputs and bridged weights, on the CPU.

Tolerances: float32 results agree to 1e-5 x max(1, max |reference|) (the
RG-LRU scan combines in another order than ``associative_scan``, the
einsums contract in another order); bfloat16 blocks to 2^-5 x max(1, max
|reference|), a few bf16 units (2^-8 relative) after the block's
projections, since one rounding of a float32 intermediate to bf16 may
fall either way.  The causal conv rounds each product and sum as the
reference does and is held to equality.

Also: chunk-at-a-time prefill equals whole-prompt prefill bit for bit
inside the port, the state and parameter counts equal the reference's,
the weight bridge keeps float32 leaves of a bf16 checkpoint float32, and
the paged attention wrappers' contract and plain versions at
RecurrentGemma-9B's head_dim 256 and G = 16.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_model
from repro.checkpoint.store import _flatten, _unflatten, save_checkpoint
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke as jax_get_smoke
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_pa_ref
from repro.kernels.paged_prefill.ref import paged_prefill_ref as jax_pp_ref
from repro.models import cache as jax_cache
from repro.models import layers as jax_layers
from repro.models import rglru as jax_rglru
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_tf
from repro_torch.checkpoint.bridge import load_params, params_from_flat
from repro_torch.configs import get_config, get_smoke
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.kernels.paged_prefill import ops as pp_ops
from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref
from repro_torch.models import cache as cache_lib
from repro_torch.models import transformer as tf
from repro_torch.models.config import REC, SSD
from repro_torch.models.layers import causal_conv1d
from repro_torch.models.rglru import apply_rglru_block, rglru_scan
from repro_torch.models.ssm import apply_ssd, ssd_chunked

ARCHS = ("recurrentgemma_9b", "mamba2_780m")
F32_TOL = 1e-5
BF16_TOL = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE-sized tensors: one intra-op thread (the test workers share the
    machine's cores); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a) -> torch.Tensor:
    """A jax or numpy array as a torch tensor (bfloat16 through its bits)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16).copy()
                                ).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _tree(tree):
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in tree.items()}
    return _t(tree)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _close(got, want, tol, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = _np(got) if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max |diff| {err:.3e} > " \
                               f"{tol * scale:.3e}"


def _jdt(dtype: str):
    return jnp.bfloat16 if dtype == "bfloat16" else jnp.float32


def _lora_bank(rng, N, d_in, d_out, r, dtype):
    return {"a": jnp.asarray(rng.standard_normal((N, d_in, r)) / np.sqrt(
                d_in), _jdt(dtype)),
            "b": jnp.asarray(rng.standard_normal((N, r, d_out)) * 0.1,
                             _jdt(dtype))}


# ------------------------------------------------------------ causal conv
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["fresh", "carried", "seq_lens"])
def test_causal_conv1d_matches_reference(dtype, mode):
    rng = np.random.default_rng(1)
    B, T, Di, W = 3, 12, 16, 4
    xs = jnp.asarray(rng.standard_normal((B, T, Di)), _jdt(dtype))
    w = jnp.asarray(rng.standard_normal((W, Di)) * 0.5, _jdt(dtype))
    state = seq = None
    if mode != "fresh":
        state = jnp.asarray(rng.standard_normal((B, W - 1, Di)),
                            _jdt(dtype))
    if mode == "seq_lens":
        seq = jnp.asarray(np.array([12, 5, 1], np.int32))
    out_j, st_j = jax_layers.causal_conv1d(xs, w, state, seq_lens=seq)
    out_t, st_t = causal_conv1d(
        _t(xs), _t(w), None if state is None else _t(state),
        seq_lens=None if seq is None else _t(seq))
    assert out_t.dtype == _t(out_j).dtype
    assert torch.equal(out_t, _t(out_j))
    assert torch.equal(st_t, _t(st_j))


# ---------------------------------------------------------------- RG-LRU
@pytest.mark.parametrize("T,block", [(24, 8), (19, 8), (5, 8)])
def test_rglru_scan_matches_reference(T, block):
    rng = np.random.default_rng(T)
    B, Di = 2, 16
    a = rng.uniform(0.5, 1.0, (B, T, Di)).astype(np.float32)
    b = rng.standard_normal((B, T, Di)).astype(np.float32)
    h0 = rng.standard_normal((B, Di)).astype(np.float32)
    h_j, last_j = jax_rglru.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                                       jnp.asarray(h0), block)
    h_t, last_t = rglru_scan(_t(a), _t(b), _t(h0), block)
    _close(h_t, h_j, F32_TOL, "h")
    _close(last_t, last_j, F32_TOL, "h_last")


def _block_case(kind, dtype, mode, seed=0):
    """(reference cfg, block params, lora, inputs) of one REC/SSD block at
    SMOKE width with a 3-adapter in/out bank."""
    arch = "recurrentgemma_9b" if kind == REC else "mamba2_780m"
    cfg = jax_get_smoke(arch).with_(dtype=dtype)
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)
    D, Di, r = cfg.d_model, cfg.d_inner, 4
    if kind == REC:
        p = jax_rglru.rglru_init(key, cfg, _jdt(dtype))
        p["w_a"]["b"] = jnp.asarray(rng.standard_normal(Di) * 0.1,
                                    _jdt(dtype))
        d_in = Di
    else:
        p = jax_ssm.ssd_init(key, cfg, _jdt(dtype))
        p["dt_bias"] = jnp.asarray(rng.standard_normal(
            cfg.ssm_num_heads) * 0.5, jnp.float32)
        d_in = 2 * Di + 2 * cfg.ssm_state_dim + cfg.ssm_num_heads
    lora = {"in": _lora_bank(rng, 3, D, d_in, r, dtype),
            "out": _lora_bank(rng, 3, Di, D, r, dtype)}
    B = 3
    T = 1 if mode == "decode" else 2 * cfg.ssm_chunk + 3
    x = jnp.asarray(rng.standard_normal((B, T, D)), _jdt(dtype))
    state = seq = None
    if mode != "fresh":
        W = cfg.ssm_conv_width
        state = {"conv": jnp.asarray(rng.standard_normal((B, W - 1, Di)),
                                     _jdt(dtype))}
        if kind == REC:
            state["h"] = jnp.asarray(rng.standard_normal((B, Di)),
                                     jnp.float32)
        else:
            state["ssm"] = jnp.asarray(rng.standard_normal(
                (B, cfg.ssm_num_heads, cfg.ssm_head_dim,
                 cfg.ssm_state_dim)) * 0.1, jnp.float32)
    if mode == "carried":
        seq = jnp.asarray(np.array([T, T - 5, 2], np.int32))
    ai = np.array([2, 0, 1], np.int32)
    return cfg, p, lora, x, state, seq, ai


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["fresh", "carried", "decode"])
@pytest.mark.parametrize("kind", [REC, SSD])
def test_block_matches_reference(kind, dtype, mode):
    cfg, p, lora, x, state, seq, ai = _block_case(kind, dtype, mode)
    apply_j = jax_rglru.apply_rglru_block if kind == REC else \
        jax_ssm.apply_ssd
    apply_t = apply_rglru_block if kind == REC else apply_ssd
    out_j, st_j = apply_j(p, cfg, x, state=state, seq_lens=seq, lora=lora,
                          lora_scaling=2.0, adapter_idx=jnp.asarray(ai),
                          lora_kernel=False)
    cfg_t = get_smoke("recurrentgemma_9b" if kind == REC
                      else "mamba2_780m").with_(dtype=dtype)
    T = x.shape[1]
    out_t, st_t = apply_t(       # per-token ids, as the stack passes them
        _tree(p), cfg_t, _t(x),
        state=None if state is None else _tree(state),
        seq_lens=None if seq is None else _t(seq), lora=_tree(lora),
        lora_scaling=2.0, adapter_idx=_t(np.repeat(ai, T)))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert out_t.dtype == _t(out_j).dtype
    _close(out_t, out_j, tol, "out")
    for name in st_j:
        assert st_t[name].dtype == _t(st_j[name]).dtype, name
        _close(st_t[name], st_j[name], tol, name)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    rng = np.random.default_rng(7)
    b, T, nh, hd, S, Q = 2, 21, 4, 8, 6, 8
    xh = rng.standard_normal((b, T, nh, hd)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, (b, T, nh)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, nh).astype(np.float32)
    Bm = rng.standard_normal((b, T, S)).astype(np.float32)
    Cm = rng.standard_normal((b, T, S)).astype(np.float32)
    h0 = rng.standard_normal((b, nh, hd, S)).astype(np.float32) \
        if with_h0 else None
    y_j, h_j = jax_ssm.ssd_chunked(
        *map(jnp.asarray, (xh, dt, a, Bm, Cm)), Q,
        h0=None if h0 is None else jnp.asarray(h0))
    y_t, h_t = ssd_chunked(*map(_t, (xh, dt, a, Bm, Cm)), Q,
                           h0=None if h0 is None else _t(h0))
    _close(y_t, y_j, F32_TOL, "y")
    _close(h_t, h_j, F32_TOL, "h_final")


# ------------------------------------------------------------ the stacks
@pytest.fixture(scope="module")
def models():
    """arch -> (jax cfg, jax params, torch cfg, torch params): SMOKE in
    float32 with a 3-adapter bank, LoRA B drawn nonzero."""
    out = {}
    for arch in ARCHS:
        cfg_j, params = build_model(arch)
        flat = _flatten(params)
        rng = np.random.default_rng(0)
        for k, v in flat.items():
            if "/lora/" in k and k.endswith("/b"):
                flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(
                    v.dtype)
        cfg_t = get_smoke(arch).with_(dtype="float32")
        out[arch] = (cfg_j, _unflatten(flat), cfg_t,
                     params_from_flat(flat, cfg_t, device="cpu"))
    return out


def _state_layers(cfg):
    return [i for i, k in enumerate(cfg.layer_kinds) if k in (REC, SSD)]


def _ref_layer(cache, cfg, i):
    """Layer i of the reference's {"periods", "tail"} cache."""
    n, j = divmod(i, len(cfg.pattern))
    if n < cfg.num_periods:
        return {k: v[n] for k, v in cache["periods"][f"p{j}"].items()}
    return cache["tail"][i - cfg.num_periods * len(cfg.pattern)]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_reference(models, arch):
    """Two prefill chunks (the second continuing the carried state, one
    row ending mid-chunk) and three decode steps through the paged pools
    and state rows: logits and every state row against the reference."""
    cfg_j, pj, cfg_t, pt = models[arch]
    rng = np.random.default_rng(2)
    NS, NB, bs, MB, C = 3, 16, 8, 5, 16
    cj = jax_cache.init_paged_cache(cfg_j, NB, bs, num_slots=NS)
    ct = cache_lib.init_paged_cache(cfg_t, NB, bs, num_slots=NS,
                                    device="cpu")
    prompts = [rng.integers(0, cfg_t.vocab_size, L).astype(np.int32)
               for L in (32, 21)]
    tbl = np.full((2, MB), -1, np.int32)
    tbl[0, :5] = [1, 2, 3, 4, 5]
    tbl[1, :4] = [6, 7, 8, 9]
    srows = np.array([0, 2], np.int32)
    ai = np.array([1, 2], np.int32)
    for c0 in (0, C):
        toks = np.zeros((2, C), np.int32)
        last = np.zeros((2,), np.int32)
        for r, p in enumerate(prompts):
            n = min(C, len(p) - c0)
            toks[r, :n] = p[c0:c0 + n]
            last[r] = n - 1
        ids = tbl[:, c0 // bs:c0 // bs + C // bs].copy()
        ids[1, ids[1] < 0] = 0
        kw = dict(tokens=toks, adapter_idx=ai,
                  start_pos=np.full((2,), c0, np.int32), last_pos=last,
                  block_tbl=tbl, chunk_ids=ids, state_rows=srows)
        kw_j = {k: jnp.asarray(v) for k, v in kw.items()}
        kw_t = {k: _t(v) for k, v in kw.items()}
        lj, cj, _ = jax_tf.forward(pj, cfg_j, kw_j.pop("tokens"), cache=cj,
                                   **kw_j)
        lt, _ = tf.forward(pt, cfg_t, kw_t.pop("tokens"), cache=ct, **kw_t)
        _close(lt, lj, F32_TOL, f"prefill logits at {c0}")
    tok = np.asarray(lj)[:, 0].argmax(-1).astype(np.int32)
    pos = np.array([32, 21], np.int32)
    for step in range(3):
        dj, cj = jax_tf.decode_step(
            pj, cfg_j, jnp.asarray(tok), cj, jnp.asarray(pos),
            adapter_idx=jnp.asarray(ai), block_tbl=jnp.asarray(tbl),
            state_rows=jnp.asarray(srows))
        dt_, _ = tf.decode_step(pt, cfg_t, _t(tok), ct, _t(pos),
                                adapter_idx=_t(ai), block_tbl=_t(tbl),
                                state_rows=_t(srows))
        _close(dt_, dj, F32_TOL, f"decode logits, step {step}")
        assert (_np(dt_).argmax(-1) == np.asarray(dj).argmax(-1)).all()
        tok, pos = np.asarray(dj).argmax(-1).astype(np.int32), pos + 1
    for i in _state_layers(cfg_t):
        ref = _ref_layer(cj, cfg_j, i)
        for name, t in ct[i].items():
            _close(t[:NS], ref[name][:NS], F32_TOL, f"layer {i} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_whole_prompt(models, arch):
    """The port's own invariant: a 32-token prompt prefilled in one
    dispatch and in two 16-token chunks (carried state between them)
    leaves bit-identical REC/SSD state rows."""
    _, _, cfg, params = models[arch]
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab_size, 32).astype(np.int32)
    states = []
    for C in (32, 16):
        cache = cache_lib.init_paged_cache(cfg, 8, 8, num_slots=1,
                                           device="cpu")
        tbl = torch.tensor([[1, 2, 3, 4]], dtype=torch.int32)
        for c0 in range(0, 32, C):
            tf.forward(params, cfg, torch.from_numpy(prompt[None, c0:c0 + C]),
                       cache=cache, adapter_idx=torch.tensor([1]),
                       start_pos=torch.tensor([c0], dtype=torch.int32),
                       last_pos=torch.tensor([C - 1], dtype=torch.int32),
                       block_tbl=tbl,
                       chunk_ids=tbl[:, c0 // 8:(c0 + C) // 8],
                       state_rows=torch.tensor([0], dtype=torch.int32))
        states.append([{k: t[0].clone() for k, t in cache[i].items()}
                       for i in _state_layers(cfg)])
    for whole, chunked in zip(*states):
        for name in whole:
            assert torch.equal(whole[name], chunked[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_state_bytes_and_param_count_match_reference(arch):
    for get_j, get_t in ((jax_get_config, get_config),
                         (jax_get_smoke, get_smoke)):
        cj, ct = get_j(arch), get_t(arch)
        assert ct.param_count() == cj.param_count()
        assert ct.ssm_num_heads == cj.ssm_num_heads
        assert cache_lib.state_bytes_per_slot(ct) == \
            jax_cache.state_bytes_per_slot(cj)
        assert cache_lib.state_bytes_per_slot(ct, torch.float32) == \
            jax_cache.state_bytes_per_slot(cj, jnp.float32)
        for kind in (REC, SSD):
            spec_j = jax_cache.slot_state_spec(kind, cj)
            spec_t = cache_lib.slot_state_spec(kind, ct)
            assert {k: s for k, (s, _) in spec_t.items()} == \
                {k: s for k, (s, _) in spec_j.items()}
    assert cache_lib.paging_unsupported_reason(get_config(arch)) is None


def test_bf16_checkpoint_keeps_float32_leaves(tmp_path):
    """A bf16 RecurrentGemma SMOKE checkpoint written by the reference's
    ``save_checkpoint``: under ``dtype=torch.bfloat16`` the bf16 leaves
    come back bit for bit and Λ (a float32 leaf) stays float32, exact."""
    cfg_j = jax_get_smoke("recurrentgemma_9b")          # bfloat16
    params = jax_tf.init_params(jax.random.PRNGKey(3), cfg_j,
                                lora_adapters=2)
    path = str(tmp_path / "rg_smoke")
    save_checkpoint(path, params)
    got = load_params(path, get_smoke("recurrentgemma_9b"), device="cpu",
                      dtype=torch.bfloat16)
    rec = got["layers"][0]["rec"]
    assert rec["lam"].dtype == torch.float32
    assert torch.equal(rec["lam"], _t(params["periods"]["p0"]["rec"]["lam"]
                                      [0]))
    assert rec["w_a"]["w"].dtype == torch.bfloat16
    assert torch.equal(rec["w_a"]["w"].view(torch.int16),
                       _t(params["periods"]["p0"]["rec"]["w_a"]["w"][0]
                          ).view(torch.int16))
    assert got["layers"][2]["attn"]["wq"]["w"].dtype == torch.bfloat16
    # the same file bridged wider: every leaf float32
    wide = load_params(path, get_smoke("recurrentgemma_9b"), device="cpu",
                       dtype=torch.float32)
    assert wide["layers"][1]["rec"]["w_x"]["w"].dtype == torch.float32


# --------------------------------------------- paged attention at hd 256
def test_paged_wrappers_admit_recurrentgemma_shape():
    cfg = get_config("recurrentgemma_9b")
    G = cfg.num_heads // cfg.num_kv_heads
    assert cfg.head_dim_ == 256 and G == 16
    assert 256 in pa_ops.HEAD_DIMS and G <= pa_ops.MAX_GROUP
    assert 256 in pp_ops.HEAD_DIMS


def test_paged_plain_versions_at_hd256_g16_match_reference():
    rng = np.random.default_rng(11)
    K, G, hd, NB, bs, MB = 1, 16, 256, 12, 8, 5
    kp = rng.standard_normal((K, NB, bs, hd)).astype(np.float32)
    vp = rng.standard_normal((K, NB, bs, hd)).astype(np.float32)
    tbl = np.full((2, MB), -1, np.int32)
    tbl[0] = [-1, 3, 7, 1, 9]                # a reclaimed entry in front
    tbl[1, :3] = [4, 8, 2]
    q = rng.standard_normal((2, K * G, hd)).astype(np.float32)
    pos = np.array([37, 20], np.int32)
    got = paged_attention_ref(*map(_t, (q, kp, vp, tbl, pos)), window=24)
    want = jax_pa_ref(*map(jnp.asarray, (q, kp, vp, tbl, pos)), window=24)
    _close(got, want, F32_TOL, "paged decode")
    C = 8
    qc = rng.standard_normal((2, C, K * G, hd)).astype(np.float32)
    q_pos = (np.array([24, 16])[:, None] + np.arange(C)[None]).astype(
        np.int32)
    got = paged_prefill_ref(*map(_t, (qc, kp, vp, tbl, q_pos)), window=24)
    want = jax_pp_ref(*map(jnp.asarray, (qc, kp, vp, tbl, q_pos)),
                      window=24)
    _close(got, want, F32_TOL, "paged prefill")
