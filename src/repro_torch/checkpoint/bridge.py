"""Weight bridge between the reference's checkpoint layout and the port's
params, both ways.

The reference (``repro/checkpoint/store.py``) flattens its parameter tree
into ``/``-joined keys, with ``#i`` for tuple indices and the period-stacked
layer layout of its ``lax.scan`` stack: ``periods/p{j}/...`` arrays carry a
leading period axis (layer ``n * len(pattern) + j``) and ``tail/#i/...``
holds the unrolled remainder layers.  A checkpoint is ``<path>.npz`` plus
``<path>.json``; bfloat16 arrays are stored as uint16 and tagged
``"bfloat16"`` in the JSON's ``dtypes``.

This module reads that format with numpy alone and unstacks it into the
port's layout: ``{"embed", "lm_head", "final_norm", "layers": [layer 0,
layer 1, ...]}``, each layer the reference's per-layer dict.  An
encoder-decoder's ``encoder/layers/...`` leaves, stacked over
``encoder_layers``, unstack the same way into ``params["encoder"]
["layers"]`` beside ``params["encoder"]["norm"]``.  ``reference_tree``
stacks the port's params back into the reference's tree, which
``checkpoint/store.py::save_checkpoint`` writes as the reference would.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.lora import _zip_map
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]
_SEP = "/"


def load_flat(path: str) -> Dict[str, np.ndarray]:
    """Read ``<path>.npz`` + ``<path>.json`` into the flat key -> array
    dict; a bfloat16-tagged array comes back as its uint16 bits wrapped in
    ``_BF16Tagged`` (numpy has no bfloat16)."""
    with open(path + ".json") as f:
        info = json.load(f)
    with np.load(path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    for k, dt in info["dtypes"].items():
        if dt == "bfloat16":
            flat[k] = _BF16Tagged(flat[k])
    return flat


class _BF16Tagged:
    """A uint16 array holding bfloat16 bits (numpy has no bfloat16)."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits


# stored dtypes that ``dtype`` recasts; float32 leaves of a low-precision
# model (the REC/SSD blocks' Λ, a_log, dt_bias, d_skip) keep their width
_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _to_tensor(v, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    if isinstance(v, _BF16Tagged):
        t = torch.from_numpy(v.bits.astype(np.uint16).view(np.int16)
                             ).view(torch.bfloat16)
    elif v.dtype.name == "bfloat16":        # ml_dtypes array held in memory
        t = torch.from_numpy(v.view(np.uint16).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(v))      # a writable copy
    if dtype is not None and t.dtype in _LOW_PRECISION:
        t = t.to(dtype)
    return t.to(device)


def _set(tree: Dict, parts: List[str], val) -> None:
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = val


def _leading(v) -> int:
    return (v.bits if isinstance(v, _BF16Tagged) else v).shape[0]


def _index(v, n: int):
    if isinstance(v, _BF16Tagged):
        return _BF16Tagged(v.bits[n])
    return v[n]


def params_from_flat(flat: Dict[str, Any], cfg: ModelConfig, *,
                     device="cuda",
                     dtype: Optional[torch.dtype] = None) -> Params:
    """Flat reference checkpoint dict -> port params on ``device``.

    ``flat`` is what ``load_flat`` returns, or the reference's in-memory
    ``_flatten(params)`` output.  ``dtype`` casts the leaves stored in a
    low-precision dtype (bfloat16, float16); float32 leaves stay float32,
    as the reference keeps them in a bf16 model (None keeps every stored
    dtype).  The layer index of ``periods/p{j}`` row n is
    ``n * len(pattern) + j``, whatever the layers' kinds (ATTN, REC,
    SSD), and ``tail/#i`` follows the periods; ``encoder/layers`` row n
    is encoder layer n."""
    pat = cfg.pattern
    n_per = len(pat)
    layers: List[Dict] = [dict() for _ in range(cfg.num_layers)]
    enc_layers: List[Dict] = [dict() for _ in range(cfg.encoder_layers)]
    out: Params = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        if parts[-1] == "__empty_tuple__":
            continue
        if parts[0] == "periods":
            j = int(parts[1][1:])                   # "p{j}"
            if _leading(val) != cfg.num_periods:
                raise ValueError(f"{key}: leading axis {_leading(val)} != "
                                 f"{cfg.num_periods} periods")
            for n in range(cfg.num_periods):
                _set(layers[n * n_per + j], parts[2:],
                     _to_tensor(_index(val, n), dtype, device))
        elif parts[0] == "tail":
            i = int(parts[1][1:])                   # "#i"
            _set(layers[cfg.num_periods * n_per + i], parts[2:],
                 _to_tensor(val, dtype, device))
        elif parts[:2] == ["encoder", "layers"]:
            if _leading(val) != cfg.encoder_layers:
                raise ValueError(f"{key}: leading axis {_leading(val)} != "
                                 f"{cfg.encoder_layers} encoder layers")
            for n in range(cfg.encoder_layers):
                _set(enc_layers[n], parts[2:],
                     _to_tensor(_index(val, n), dtype, device))
        else:
            _set(out, parts, _to_tensor(val, dtype, device))
    if any(not lp for lp in layers + enc_layers):
        raise ValueError("checkpoint is missing layers for this config")
    out["layers"] = layers
    if enc_layers:
        out.setdefault("encoder", {})["layers"] = enc_layers
    return out


def load_params(path: str, cfg: ModelConfig, *, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Params:
    """Read a reference ``save_checkpoint`` file into port params."""
    return params_from_flat(load_flat(path), cfg, device=device, dtype=dtype)


def _stack(rows: List[Params]) -> Params:
    return _zip_map(lambda *xs: None if xs[0] is None else torch.stack(xs),
                    *rows)


def reference_tree(params: Params, cfg: ModelConfig) -> Params:
    """Port params -> the reference's model tree (the inverse of
    ``params_from_flat``): layer ``n * len(pattern) + j`` becomes row n of
    ``periods/p{j}``, the layers past the last whole period the tuple
    ``tail``, and an encoder's layers one stack ``encoder/layers``.  The
    other entries are the port's own tensors; the stacks are new ones on
    the leaves' device."""
    n_per = len(cfg.pattern)
    layers = params["layers"]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"{len(layers)} layers for a config of "
                         f"{cfg.num_layers}")
    out: Params = {k: v for k, v in params.items()
                   if k not in ("layers", "encoder")}
    out["periods"] = {f"p{j}": _stack([layers[n * n_per + j] for n in
                                       range(cfg.num_periods)])
                      for j in range(n_per)}
    out["tail"] = tuple(layers[cfg.num_periods * n_per:])
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {**{k: v for k, v in enc.items() if k != "layers"},
                          "layers": _stack(enc["layers"])}
    return out
