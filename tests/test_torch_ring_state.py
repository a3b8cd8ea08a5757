"""The warm-function engine on stacks with recurrent state: REC (RG-LRU)
and SSD (Mamba-2) layers over ring caches, held against the reference's
``InferenceEngine`` on the CPU with bridged SMOKE weights.

RecurrentGemma SMOKE (REC, REC, ATTN; a 16-key window, ``ssm_chunk`` 8)
and Mamba2 SMOKE (two SSD layers, ``ssm_chunk`` 8) generate greedily
after prompts of 13 and 29 tokens: neither a multiple of the scans'
chunk, and 29 past RecurrentGemma's window, so its attention layers take
the ring-overflow branch.  The tokens must equal the reference's, and the
ring state after ``generate`` (conv tails and the float32 ``h`` / ``ssm``
states; the attention rings' slots, positions and K/V) must agree within
1e-5 x max(1, max |reference|): the scans combine in another order than
the reference's ``associative_scan`` and einsums.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import build_model
from repro.checkpoint.store import _flatten, _unflatten
from repro.core.engine import InferenceEngine as JaxEngine
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.configs import get_smoke
from repro_torch.core.engine import InferenceEngine
from repro_torch.models import cache as cache_lib
from repro_torch.models.config import ATTN

ARCHS = ("recurrentgemma_9b", "mamba2_780m")
TOL = 1e-5
CONTEXT = 48


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """SMOKE-sized tensors: one intra-op thread (the test workers share the
    machine's cores); the count is restored after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engines():
    """arch -> (reference engine, port engine, torch cfg) on the same
    SMOKE weights (float32, 3-adapter bank with nonzero LoRA B)."""
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
        pt = params_from_flat(flat, cfg_t, device="cpu")
        out[arch] = (JaxEngine(cfg_j, _unflatten(flat), max_context=CONTEXT),
                     InferenceEngine(cfg_t, pt, max_context=CONTEXT,
                                     device="cpu"),
                     cfg_t)
    return out


def _ref_layer(cache, cfg, i):
    """Layer i of the reference's {"periods", "tail"} cache."""
    n, j = divmod(i, len(cfg.pattern))
    if n < cfg.num_periods:
        return {k: v[n] for k, v in cache["periods"][f"p{j}"].items()}
    return cache["tail"][i - cfg.num_periods * len(cfg.pattern)]


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= TOL * scale, f"{what}: {err:.3e} > {TOL * scale:.3e}"


@pytest.mark.parametrize("T", [13, 29])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(engines, arch, T):
    ej, et, cfg = engines[arch]
    rng = np.random.default_rng(T)
    toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    ai = np.array([2, 0], np.int32)
    want, cj = ej.generate(jnp.asarray(toks), 6,
                           adapter_idx=jnp.asarray(ai))
    got, ct = et.generate(torch.from_numpy(toks), 6,
                          adapter_idx=torch.from_numpy(ai))
    assert got.tolist() == np.asarray(want).tolist()
    for i, kind in enumerate(cfg.layer_kinds):
        ref = _ref_layer(cj, cfg, i)
        assert ct[i]["idx"] == T + 5
        for name, t in ct[i].items():
            if name == "idx":
                continue
            if name == "slot_pos":
                assert t.tolist() == np.asarray(ref[name]).tolist()
            else:
                assert t.dtype == (torch.float32 if name in ("h", "ssm")
                                   or kind == ATTN else cfg.torch_dtype)
                _close(t, ref[name], f"layer {i} {kind} {name}")


@pytest.mark.parametrize("arch", ARCHS)
def test_second_generate_of_a_batch_size_starts_from_zero_state(engines,
                                                                arch):
    """The engine keeps one ring per batch size and empties it for the next
    ``generate``: the REC/SSD state is zeroed with the K/V, so the same
    batch gives the same tokens again, after another batch ran there."""
    _, et, cfg = engines[arch]
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 11))
                         .astype(np.int32))
    b = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 11))
                         .astype(np.int32))
    ai = torch.tensor([0, 1, 2], dtype=torch.int32)
    first, cache = et.generate(a, 5, adapter_idx=ai)
    et.generate(b, 5, adapter_idx=ai)
    again, cache2 = et.generate(a, 5, adapter_idx=ai)
    assert cache2 is cache
    assert again.tolist() == first.tolist()
    assert et.captures()[(3, CONTEXT)] == 1         # one step, three runs


def test_ring_state_layout_and_reset():
    """``init_cache`` on a hybrid stack: the reference's rec_cache /
    ssd_cache shapes and dtypes (conv in the model dtype, the recurrent
    state in float32) with the port's token counter; ``reset_ring``
    empties every kind in place."""
    for arch in ARCHS:
        cfg = get_smoke(arch)
        cache = cache_lib.init_cache(cfg, 2, 40, device="cpu")
        for kind, layer in zip(cfg.layer_kinds, cache):
            assert layer["idx"] == 0
            if kind == ATTN:
                assert layer["k"].shape == (2, cfg.sliding_window,
                                            cfg.num_kv_heads, cfg.head_dim_)
                continue
            want = cache_lib.slot_state_spec(kind, cfg)
            assert {k: (tuple(t.shape[1:]), t.dtype)
                    for k, t in layer.items() if k != "idx"} == want
            for t in layer.values():
                if torch.is_tensor(t):
                    t.fill_(1)
            layer["idx"] = 7
        ptrs = [t.data_ptr() for layer in cache for t in layer.values()
                if torch.is_tensor(t)]
        cache_lib.reset_ring(cache)
        assert ptrs == [t.data_ptr() for layer in cache
                        for t in layer.values() if torch.is_tensor(t)]
        for layer in cache:
            assert layer["idx"] == 0
            for name, t in layer.items():
                if name == "slot_pos":
                    assert bool((t == -1).all())
                elif torch.is_tensor(t):
                    assert not t.any()


def test_prefill_into_a_used_state_ring_is_refused(engines):
    _, et, cfg = engines["mamba2_780m"]
    toks = torch.zeros((1, 9), dtype=torch.int32)
    ai = torch.zeros(1, dtype=torch.int32)
    _, cache = et.prefill(toks, ai)
    with pytest.raises(ValueError, match="fresh cache"):
        et.prefill(toks, ai, cache=cache)
