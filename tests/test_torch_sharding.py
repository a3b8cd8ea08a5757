"""The port's sharding policy (``repro_torch/launch/sharding.py``) against
the reference's (``repro/launch/sharding.py``), spec for spec, on the
reference tests' shape-only ``FakeMesh``: every param leaf of all twelve
configs at full size (meta tensors against ``eval_shape``) on both
production meshes under both option sets, including Mixtral's stacked
experts; the cache and batch specs of the reference's
``test_cache_and_batch_specs_divisible`` cases; the policy's knobs.

The port keeps one dict a layer where the reference stacks periods, so a
port leaf is compared with the reference's spec for the leaf where
``checkpoint/bridge.py::reference_tree`` puts it, without the stacked
period dim (``sharding.reference_place``).
"""
import _torch_threads  # noqa: F401  (torch threads per xdist worker)
import numpy as np
import pytest

from repro.configs import ARCH_IDS, get_config as ref_config
from repro.launch import sharding as rs
from repro.launch import specs as rsp
from repro_torch.configs import get_config
from repro_torch.launch import sharding as ps
from repro_torch.launch import specs as psp


class FakeMesh:
    """Shape-only stand-in (the reference tests' own)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}
OPTIONS = {"baseline": (rs.BASELINE, ps.BASELINE),
           "optimized": (rs.OPTIMIZED, ps.OPTIMIZED)}


def _leaves(tree, path=()):
    """(path, leaf) of a data tree; tuples index as "#i"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (f"#{i}",))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[int(k[1:])] if isinstance(tree, (list, tuple)) else tree[k]
    return tree


def _compare_params(ref_tree, ref_specs, port_tree, port_specs, cfg):
    """Every port leaf's spec against the reference's where it sits;
    returns the number of leaves compared."""
    n = 0
    for path, leaf in _leaves(port_tree):
        if leaf is None:
            continue
        ref_path, lead = ps.reference_place(cfg, path)
        want = tuple(_at(ref_specs, ref_path))
        if lead is not None:
            assert _at(ref_tree, ref_path).shape[0] == lead
            want = want[1:]
        assert _at(port_specs, path) == want, (path, ref_path)
        n += 1
    return n


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    rcfg, cfg = ref_config(arch), get_config(arch)
    ref_params = rsp.abstract_params(rcfg)
    params = psp.abstract_params(cfg)
    assert sum(t.numel() for _, t in _leaves(params) if t is not None) == \
        sum(int(np.prod(t.shape)) for _, t in _leaves(ref_params))
    for mesh in MESHES.values():
        for ropts, popts in OPTIONS.values():
            n = _compare_params(ref_params,
                                rs.params_specs(ref_params, mesh, rcfg, ropts),
                                params, ps.params_specs(params, mesh, cfg,
                                                        popts), cfg)
            assert n > 0


def test_mixtral_stacked_experts_take_the_matrix_rule():
    """The expert rule fires on 3-D leaves only; the reference stacks
    Mixtral's experts (56, 8, 6144, 16384), so under OPTIMIZED they take
    the generic matrix rule, and so must the port's per-layer leaf."""
    cfg = get_config("mixtral_8x22b")
    params = psp.abstract_params(cfg)
    specs = ps.params_specs(params, MESHES["16x16"], cfg, ps.OPTIMIZED)
    assert specs["layers"][0]["moe"]["wi"] == (None, "data", "model")
    assert ps.spec_for_leaf(("periods", "p0", "moe", "wi"),
                            (56, 8, 6144, 16384), MESHES["16x16"], cfg,
                            weight_mode="fsdp2d") == \
        (None, None, "data", "model")
    # the rule the port's 3-D leaf alone would wrongly trigger
    assert ps.spec_for_leaf(("tail", "#0", "moe", "wi"), (8, 6144, 16384),
                            MESHES["16x16"], cfg, weight_mode="fsdp2d") == \
        (None, "data", "model")


@pytest.mark.parametrize("arch", ["llama2_7b", "mixtral_8x22b",
                                  "mamba2_780m", "recurrentgemma_9b"])
@pytest.mark.parametrize("shape", list(psp.INPUT_SHAPES))
def test_cache_and_batch_specs_match_reference(arch, shape):
    rcfg = rsp.adapt_config(ref_config(arch), shape)
    cfg = psp.adapt_config(get_config(arch), shape)
    assert (rcfg is None) == (cfg is None)
    if cfg is None:
        return
    sh = psp.INPUT_SHAPES[shape]
    B, S = sh["global_batch"], psp.effective_cache_len(cfg, sh["seq_len"])
    ref_cache = rsp.abstract_cache(rcfg, B, S)
    cache = psp.abstract_cache(cfg, B, S)
    for mesh in MESHES.values():
        for ropts, popts in OPTIONS.values():
            rspecs = rs.cache_specs(ref_cache, mesh, rcfg, ropts)
            pspecs = ps.cache_specs(cache, mesh, cfg, popts)
            for i, layer in enumerate(cache):
                ref_path, lead = ps.reference_place(cfg, ("layers", f"#{i}"))
                rl = _at(rspecs, ref_path)
                for name, leaf in layer.items():
                    if name == "idx":        # the port's host counter
                        assert pspecs[i][name] is None
                        continue
                    want = tuple(rl[name])
                    want = want[1:] if lead is not None else want
                    assert pspecs[i][name] == want, (i, name)
        batch = psp.batch_inputs(cfg, B, min(sh["seq_len"], 4096))
        rbatch = rsp.batch_inputs(rcfg, B, min(sh["seq_len"], 4096))
        rb = rs.batch_specs(rbatch, mesh)
        pb = ps.batch_specs(batch, mesh)
        assert set(pb) == set(rb)
        for k in pb:
            assert pb[k] == tuple(rb[k])
            assert tuple(batch[k].shape) == tuple(rbatch[k].shape)


def test_resolve_weight_mode_and_knobs():
    m = MESHES["16x16"]
    for arch in ("phi3_medium_14b", "nemotron_4_340b", "llama2_7b"):
        for ro, po in OPTIONS.values():
            assert ps.resolve_weight_mode(get_config(arch), m, po) == \
                rs.resolve_weight_mode(ref_config(arch), m, ro)
    cfg = get_config("phi3_medium_14b")
    s = ps.spec_for_leaf(("periods", "p0", "attn", "wo", "w"),
                         (2, 5120, 5120), m, cfg, weight_mode="tp",
                         row_parallel_down=True)
    assert s == (None, "model", None)
    assert ps.spec_for_leaf(("final_norm", "scale"), (4096,), m, cfg) == \
        (None,)


def test_to_placements_shards_pod_then_data():
    """A dim over ("pod", "data") is Shard(d) on both mesh dims (DTensor
    splits it in mesh-dim order: pod-major, as JAX); axes out of the
    mesh's order, or a mesh dim on two tensor dims, are refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = MESHES["2x16x16"]
    assert ps.to_placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert ps.to_placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="order"):
        ps.to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="two dims"):
        ps.to_placements(("model", "model"), mesh)
    assert ps.local_shape((64, 32, 48), (("pod", "data"), None, "model"),
                          mesh) == (2, 32, 3)
