"""C1 in the port — unmerged LoRA + backbone sharing (``core/lora.py``,
``core/sharing.py``), mirroring ``tests/test_lora_core.py`` and held
against the reference's functions on the same weights.

Tolerances, float32: merged weights within atol = rtol = 1e-5 (one
float32 product A @ B summed in another order); logits within 1e-4.
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import _flatten, _unflatten
from repro.core import lora as jlora
from repro.core.sharing import BackboneStore as JaxStore
from repro.models import transformer as jtf
from repro.models.config import LoRAConfig as JaxLoRA
from repro.models.config import ModelConfig as JaxConfig
from repro_torch.checkpoint.bridge import params_from_flat
from repro_torch.core import lora
from repro_torch.core.sharing import BackboneStore, FunctionInstance
from repro_torch.models import transformer as tf
from repro_torch.models.config import LoRAConfig, ModelConfig

_CFG = dict(name="d", family="dense", num_layers=2, d_model=64, num_heads=2,
            num_kv_heads=1, d_ff=128, vocab_size=64, dtype="float32")
CFG_J = JaxConfig(**_CFG, lora=JaxLoRA(rank=4, alpha=8.0, num_adapters=3))
CFG = ModelConfig(**_CFG, lora=LoRAConfig(rank=4, alpha=8.0, num_adapters=3))
TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def both():
    """(reference params, port params): one tree with a 3-adapter bank and
    nonzero LoRA B, carried over by the weight bridge."""
    flat = _flatten(jtf.init_params(jax.random.PRNGKey(0), CFG_J,
                                    lora_adapters=3))
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if "/lora/" in k:
            flat[k] = (rng.standard_normal(v.shape) * 0.05).astype(v.dtype)
    return _unflatten(flat), params_from_flat(flat, CFG, device="cpu")


def _logits(params, toks, adapter_idx=None):
    cache = tf.init_cache(CFG, toks.shape[0], 16, device="cpu")
    idx = None if adapter_idx is None else torch.tensor(
        adapter_idx, dtype=torch.int32)
    logits, _ = tf.forward(params, CFG, toks, cache=cache, adapter_idx=idx)
    return logits


def _toks(B=3, T=8, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 64, (B, T)).astype(np.int32))


def _assert_trees_close(port_tree, ref_tree):
    bridged = params_from_flat(_flatten(ref_tree), CFG, device="cpu")

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)

    walk(port_tree, bridged)


def test_partition_roundtrip(both):
    _, pt = both
    bb, ad = lora.partition_lora(pt)
    back = lora.combine_lora(bb, ad)
    for a, b in zip(lora.tree_leaves(pt), lora.tree_leaves(back)):
        assert a is b                         # recombined without copies
    assert all(lp["attn"]["lora"][t]["a"] is None
               for lp in bb["layers"] for t in "qkvo")
    assert lora.lora_param_count(pt) == jlora.lora_param_count(both[0])
    assert lora.backbone_param_count(pt) == \
        jlora.backbone_param_count(both[0])
    assert lora.adapter_bytes(CFG) == jlora.adapter_bytes(CFG_J)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_merge_adapter_matches_reference(both, i):
    pj, pt = both
    _assert_trees_close(lora.merge_adapter(pt, CFG, adapter_idx=i),
                        jlora.merge_adapter(pj, CFG_J, adapter_idx=i))


def test_merge_adapter_needs_an_index_for_a_bank(both):
    with pytest.raises(ValueError, match="adapter_idx"):
        lora.merge_adapter(both[1], CFG)


def test_unmerged_equals_merged_oracle(both):
    """The separate backbone/adapter computation (SGMV over the bank) ==
    folding each adapter into a copy of the weights."""
    _, pt = both
    toks = _toks()
    unmerged = _logits(pt, toks, [0, 1, 2])
    for i in range(3):
        merged = _logits(lora.merge_adapter(pt, CFG, adapter_idx=i),
                         toks[i:i + 1])
        np.testing.assert_allclose(unmerged[i].numpy(), merged[0].numpy(),
                                   **LOGIT_TOL)


def test_adapter_routing_actually_differs(both):
    toks = _toks(B=1, seed=2)
    l0 = _logits(both[1], toks, [0])
    l1 = _logits(both[1], toks, [1])
    assert float((l0 - l1).abs().max()) > 1e-3


@pytest.mark.parametrize("i", [0, 2])
def test_single_adapter_dense_matches_reference(both, i):
    """A function built from ``take_adapter`` applies its one adapter with
    no ids (``dense``'s single-adapter branch), as the reference does, and
    agrees with routing row by row through the bank."""
    pj, pt = both
    bb, ad = lora.partition_lora(pt)
    single = lora.combine_lora(bb, lora.take_adapter(ad, i))
    toks = _toks(B=2, seed=3)
    got = _logits(single, toks)
    bbj, adj = jlora.partition_lora(pj)
    want, _, _ = jtf.forward(jlora.combine_lora(bbj,
                                                jlora.take_adapter(adj, i)),
                             CFG_J, jnp.asarray(toks.numpy()),
                             use_chunked=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    np.testing.assert_allclose(got.numpy(),
                               _logits(pt, toks, [i, i]).numpy(),
                               **LOGIT_TOL)


def test_stack_select_take_roundtrip(both):
    pj, pt = both
    _, bank = lora.partition_lora(pt)
    assert lora.bank_size(bank) == 3
    singles = [lora.take_adapter(bank, i) for i in range(3)]
    assert lora.tree_leaves(singles[0])[0].shape == (64, 4)
    stacked = lora.stack_adapters(singles)
    for a, b in zip(lora.tree_leaves(stacked), lora.tree_leaves(bank)):
        assert torch.equal(a, b)
    for a, b in zip(lora.tree_leaves(lora.select_adapter(stacked, 1)),
                    lora.tree_leaves(singles[1])):
        assert torch.equal(a, b)
    _, bank_j = jlora.partition_lora(pj)
    assert lora.bank_size(bank) == jlora.bank_size(bank_j)
    ref = jlora.take_adapter(bank_j, 1)
    ref_leaves = [np.asarray(ref["periods"]["p0"]["attn"]["lora"][t][m][n])
                  for n in range(2) for t in "qkvo" for m in "ab"]
    port_leaves = [singles[1]["layers"][n]["attn"]["lora"][t][m].numpy()
                   for n in range(2) for t in "qkvo" for m in "ab"]
    for a, b in zip(port_leaves, ref_leaves):
        np.testing.assert_array_equal(a, b)


def test_init_adapter_bank_shapes():
    gen = torch.Generator()
    gen.manual_seed(0)
    bank = lora.init_adapter_bank(gen, CFG, 5, device="cpu")
    assert lora.bank_size(bank) == 5
    q = bank["layers"][0]["attn"]["lora"]["q"]
    assert q["a"].shape == (5, 64, 4) and q["b"].shape == (5, 4, 64)
    assert not bool(q["b"].any())            # B = 0, the reference's init


def test_backbone_store_zero_copy_and_refcount(both):
    pj, pt = both
    store = BackboneStore()
    store.register("bb", CFG, pt)
    with pytest.raises(ValueError):
        store.register("bb", CFG, pt)
    h1, h2 = store.open("bb"), store.open("bb")
    l1, l2 = lora.tree_leaves(h1.params), lora.tree_leaves(h2.params)
    assert len(l1) == len(lora.tree_leaves(lora.partition_lora(pt)[0]))
    assert all(a is b for a, b in zip(l1, l2)), "handles must be zero-copy"
    assert all(a.data_ptr() == b.data_ptr() for a, b in zip(l1, l2))
    bb_orig = lora.tree_leaves(lora.partition_lora(pt)[0])
    assert all(a is b for a, b in zip(l1, bb_orig))
    assert store.refcount("bb") == 2
    jstore = JaxStore()
    jstore.register("bb", CFG_J, pj)
    assert store.nbytes("bb") == jstore.nbytes("bb")
    assert store.total_bytes() == store.nbytes("bb")
    assert store.ids() == ["bb"]
    assert not store.evict("bb"), "live handles must block eviction"
    h1.close()
    h1.close()                               # closing twice releases once
    assert store.refcount("bb") == 1
    with pytest.raises(RuntimeError, match="closed"):
        _ = h1.params
    assert not store.evict("bb")
    with h2:
        pass
    assert store.refcount("bb") == 0
    assert store.evict("bb")
    assert store.ids() == [] and not store.evict("bb")


def test_function_instances_are_isolated(both):
    """Each function's adapters and cache are private; only the backbone is
    shared, by identity."""
    _, pt = both
    store = BackboneStore()
    store.register("bb", CFG, pt)
    _, bank = lora.partition_lora(pt)
    f1 = FunctionInstance("f1", store.open("bb"), bank, 0)
    f2 = FunctionInstance("f2", store.open("bb"),
                          lora.take_adapter(bank, 1), None)
    f1.cache = tf.init_cache(CFG, 1, 8, device="cpu")
    assert f2.cache is None
    assert f1.config is CFG and f2.adapter_index is None
    bb1, ad1 = lora.partition_lora(f1.params)
    bb2, ad2 = lora.partition_lora(f2.params)
    assert all(a is b for a, b in zip(lora.tree_leaves(bb1),
                                      lora.tree_leaves(bb2)))
    assert lora.bank_size(ad1) == 3
    assert lora.tree_leaves(ad2)[0].dim() == 2
    f1.close()
    f2.close()
    assert store.refcount("bb") == 0
