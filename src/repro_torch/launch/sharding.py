"""Divisibility-aware sharding policy for params, caches and batches
(port of ``repro/launch/sharding.py``, rule for rule).

Strategy (the reference's baseline):
  * 2-D weight sharding (FSDP x TP): the output/feature dim of every large
    matrix shards over "model"; the input dim shards over the data axes
    ("pod", "data" flattened), so large backbones fit a device's memory on
    both production meshes.
  * Activations and batches shard over the data axes.
  * KV caches: batch over the data axes; kv heads over "model" when
    divisible, else head_dim (or the sequence, ``kv_fallback="seq"``),
    else replicated.
  * Stacked leading dims (layer periods, adapter banks) never shard.
  * Anything small (norms, biases, LoRA) replicates.
Every rule checks divisibility before it applies.

A spec is the port's own type: a tuple with one entry per tensor dim,
``None`` (replicated), an axis name, or a tuple of axis names (one dim
over several mesh axes, major first), so ``spec == tuple(PartitionSpec)``
compares it with the reference's.  ``to_placements`` turns a spec into
DTensor placements on a ``DeviceMesh``.

The policy is the reference's, applied where the reference applies it.
The reference stacks its layers as ``periods/p{j}`` leaves with a leading
period dim, then a ``tail`` tuple; the port keeps ``params["layers"]``, one
dict a layer (``checkpoint/bridge.py``).  So ``params_specs`` gives each of
the port's per-layer leaves the trailing dims of the spec the reference
gives that leaf where ``bridge.reference_tree`` places it: shape and path
are the reference's (a period layer's leaf gets the leading period dim
back) before a rule is asked.  This matters: the MoE expert rule fires on
3-D leaves only, so Mixtral's experts, stacked (56, 8, 6144, 16384) in the
reference, take the generic matrix rule (``(None, None, data, model)``
under ``OPTIMIZED``), not the expert-axis rule that the port's 3-D
(8, 6144, 16384) leaf alone would trigger.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import axis_names, axis_sizes, batch_axes
from repro_torch.models.config import ModelConfig

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


@dataclasses.dataclass(frozen=True)
class ShardingOptions:
    """The reference's knobs.

    weight_mode:
      "fsdp2d" — baseline: row dim over the data axes, col dim over model.
      "tp"     — tensor-parallel only: col over model, rows replicated.
      "auto"   — "tp" when the weights fit a device under tp_budget, else
                 "fsdp2d" (the optimized default).
    moe_shard_map: shard-local MoE routing (``models/moe.py::
    set_parallel_mesh``).  kv_fallback: "hd" shards head_dim when the kv
    heads do not divide "model", "seq" the sequence.  moe_dispatch:
    "ragged" | "capacity".  row_parallel_down: Megatron-style
    down-projections (attn out, MLP down, recurrent out) row-parallel over
    "model"."""
    weight_mode: str = "fsdp2d"
    tp_budget_bytes: int = 10 * 2 ** 30
    moe_shard_map: bool = False
    kv_fallback: str = "hd"
    moe_dispatch: str = "ragged"
    row_parallel_down: bool = False


BASELINE = ShardingOptions()
OPTIMIZED = ShardingOptions(weight_mode="auto", moe_shard_map=True,
                            kv_fallback="seq", moe_dispatch="capacity",
                            row_parallel_down=True)


def resolve_weight_mode(cfg: ModelConfig, mesh, opts: ShardingOptions) -> str:
    if opts.weight_mode != "auto":
        return opts.weight_mode
    per_chip = 2 * cfg.param_count() / axis_sizes(mesh)["model"]
    return "tp" if per_chip <= opts.tp_budget_bytes else "fsdp2d"


def _axis_size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _fits(dim: int, mesh, axes) -> bool:
    return dim % _axis_size(mesh, axes) == 0


def _data_entry(mesh) -> Axis:
    """The spec entry of the data axes: "data" alone, or ("pod", "data")
    (``PartitionSpec`` normalises a one-axis tuple to its name)."""
    da = batch_axes(mesh)
    return da[0] if len(da) == 1 else da


def _none(n: int) -> Spec:
    return (None,) * n


def spec_for_leaf(path: Tuple[str, ...], shape: Tuple[int, ...], mesh,
                  cfg: ModelConfig, weight_mode: str = "fsdp2d",
                  row_parallel_down: bool = False) -> Spec:
    """Spec of one parameter leaf, by its path and shape IN THE
    REFERENCE'S TREE (``params_specs`` maps the port's leaves there)."""
    name = path[-1] if path else ""
    in_lora = "lora" in path
    da = _data_entry(mesh)
    down_proj = (row_parallel_down and len(path) >= 2 and path[-1] == "w"
                 and path[-2] in ("wo", "out", "out_proj"))

    def matrix_spec(nd: int, d_in: int, d_out: int) -> Spec:
        lead = _none(nd - 2)
        # replicate small matrices (< 1 MiB of elements)
        if d_in * d_out < (1 << 20):
            return _none(nd)
        if down_proj and _fits(d_in, mesh, "model"):
            return lead + ("model", None)
        col = "model" if _fits(d_out, mesh, "model") else None
        row = None
        if weight_mode == "fsdp2d" and _fits(d_in, mesh, da):
            row = da
        return lead + (row, col)

    if in_lora:
        return _none(len(shape))
    if name in ("scale", "bias", "b", "a_log", "dt_bias", "d_skip", "lam"):
        return _none(len(shape))
    if name == "embed" or (path and path[-1] == "lm_head"):
        V, D = shape[-2], shape[-1]
        v_ax = da if (weight_mode == "fsdp2d" and _fits(V, mesh, da)) \
            else None
        return _none(len(shape) - 2) + (
            v_ax, "model" if _fits(D, mesh, "model") else None)
    if name == "conv":
        return _none(len(shape))
    if name in ("wi", "wg", "wo") and len(shape) == 3 and "moe" in path:
        # MoE experts (E, D, F) of an unstacked (tail) layer
        E, D, F = shape
        d_ax = da if (weight_mode == "fsdp2d" and _fits(D, mesh, da)) \
            else None
        if _fits(E, mesh, "model"):
            return ("model", d_ax, None)
        return (None, d_ax, "model" if _fits(F, mesh, "model") else None)
    if len(shape) >= 2:
        return matrix_spec(len(shape), shape[-2], shape[-1])
    return _none(len(shape))


def _walk(tree, path: Tuple[str, ...], leaf_fn):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,), leaf_fn) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_walk(v, path + (f"#{i}",), leaf_fn)
                          for i, v in enumerate(tree))
    if tree is None or not hasattr(tree, "shape"):
        return None
    return leaf_fn(path, tuple(tree.shape))


def reference_place(cfg: ModelConfig, path: Tuple[str, ...]
                    ) -> Tuple[Tuple[str, ...], Optional[int]]:
    """Where ``bridge.reference_tree`` puts the port's leaf at ``path``:
    (the reference's path, the stacked leading dim it gains or None).
    Layer ``n * len(pattern) + j`` is row n of ``periods/p{j}``; layers past
    the last whole period are ``tail/#i``; encoder layers stack into
    ``encoder/layers``."""
    if len(path) >= 2 and path[0] == "layers":
        i = int(path[1][1:])
        n_per = len(cfg.pattern)
        if i < cfg.num_periods * n_per:
            return ("periods", f"p{i % n_per}") + path[2:], cfg.num_periods
        return ("tail", f"#{i - cfg.num_periods * n_per}") + path[2:], None
    if path[:2] == ("encoder", "layers") and len(path) >= 3:
        return ("encoder", "layers") + path[3:], cfg.encoder_layers
    return path, None


def params_specs(params, mesh, cfg: ModelConfig,
                 opts: ShardingOptions = BASELINE):
    """Spec tree matching a port params tree (tensors of any device, meta
    included; None leaves stay None).  Each leaf's spec is the trailing
    dims of the reference's spec for it (module docstring)."""
    mode = resolve_weight_mode(cfg, mesh, opts)

    def leaf(path, shape):
        ref_path, lead = reference_place(cfg, path)
        ref_shape = shape if lead is None else (lead,) + shape
        spec = spec_for_leaf(ref_path, ref_shape, mesh, cfg,
                             weight_mode=mode,
                             row_parallel_down=opts.row_parallel_down)
        return spec if lead is None else spec[1:]

    return _walk(params, (), leaf)


def cache_specs(cache, mesh, cfg: ModelConfig,
                opts: ShardingOptions = BASELINE):
    """Specs for the ring cache (a list of layer dicts).  The reference's
    rules read only the trailing dims, so a port leaf's spec is the
    reference's without the period dim.  The host counter ``idx`` has
    none (None); ``xpos`` and ``slot_pos`` replicate."""
    da = _data_entry(mesh)

    def leaf_spec(path, shape) -> Spec:
        name = path[-1]
        nd = len(shape)
        if name in ("k", "v", "xk", "xv"):
            B, S, K, hd = shape[-4:]
            b_ax = da if _fits(B, mesh, da) else None
            if _fits(K, mesh, "model"):
                return _none(nd - 4) + (b_ax, None, "model", None)
            if opts.kv_fallback == "seq" and _fits(S, mesh, "model"):
                return _none(nd - 4) + (b_ax, "model", None, None)
            if _fits(hd, mesh, "model"):
                return _none(nd - 4) + (b_ax, None, None, "model")
            return _none(nd - 4) + (b_ax, None, None, None)
        if name == "ssm":
            B, nh = shape[-4], shape[-3]
            b_ax = da if _fits(B, mesh, da) else None
            h_ax = "model" if _fits(nh, mesh, "model") else None
            return _none(nd - 4) + (b_ax, h_ax, None, None)
        if name == "conv":
            B, Di = shape[-3], shape[-1]
            b_ax = da if _fits(B, mesh, da) else None
            return _none(nd - 3) + (
                b_ax, None, "model" if _fits(Di, mesh, "model") else None)
        if name == "h":
            B, Di = shape[-2], shape[-1]
            b_ax = da if _fits(B, mesh, da) else None
            return _none(nd - 2) + (
                b_ax, "model" if _fits(Di, mesh, "model") else None)
        return _none(nd)

    return _walk(cache, (), leaf_spec)


def batch_specs(batch, mesh):
    """Tokens, labels, embeddings: batch dim over the data axes."""
    da = _data_entry(mesh)

    def leaf(path, shape) -> Spec:
        if not shape:
            return ()
        b_ax = da if _fits(shape[0], mesh, da) else None
        return (b_ax,) + _none(len(shape) - 1)

    return _walk(batch, (), leaf)


def to_placements(spec: Spec, mesh) -> List[Any]:
    """DTensor placements (one per mesh dim) of a spec: ``Shard(d)`` on
    every mesh dim named by tensor dim d's entry, ``Replicate()`` on the
    others.  A dim over ("pod", "data") is sharded pod-major, as JAX
    shards it: DTensor splits a dim over several mesh dims in mesh-dim
    order, so the entry's axes must come in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out: List[Any] = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {names[i]} shards two dims of "
                                 f"spec {spec}")
            out[i] = Shard(d)
    return out


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """A device's shard shape under ``spec`` (every rule checked
    divisibility, so shards are even)."""
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is not None:
            n = _axis_size(mesh, entry)
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"over {entry} ({n})")
            out[d] //= n
    return tuple(out)



def shard_of(t, spec: Spec, mesh):
    """This rank's shard of a whole tensor ``t`` under ``spec`` (every
    rank holds ``t``: no communication).  A dim over several mesh axes is
    cut major axis first, as ``to_placements`` places it."""
    coord = mesh.get_coordinate()
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        n, i = 1, 0
        for a in axes:
            i = i * sizes[a] + coord[names.index(a)]
            n *= sizes[a]
        size = t.shape[d] // n
        t = t.narrow(d, i * size, size)
    return t.contiguous()
