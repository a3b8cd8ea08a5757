"""Weight bridge: the reference's flat checkpoint format -> port params.

The reference (``repro/checkpoint/store.py``) flattens its parameter tree
into ``/``-joined keys, with ``#i`` for tuple indices and the period-stacked
layer layout of its ``lax.scan`` stack: ``periods/p{j}/...`` arrays carry a
leading period axis (layer ``n * len(pattern) + j``) and ``tail/#i/...``
holds the unrolled remainder layers.  A checkpoint is ``<path>.npz`` plus
``<path>.json``; bfloat16 arrays are stored as uint16 and tagged
``"bfloat16"`` in the JSON's ``dtypes``.

This module reads that format with numpy alone and unstacks it into the
port's layout: ``{"embed", "lm_head", "final_norm", "layers": [layer 0,
layer 1, ...]}``, each layer the reference's per-layer dict.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

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


def _to_tensor(v, dtype: Optional[torch.dtype], device) -> torch.Tensor:
    if isinstance(v, _BF16Tagged):
        t = torch.from_numpy(v.bits.astype(np.uint16).view(np.int16)
                             ).view(torch.bfloat16)
    elif v.dtype.name == "bfloat16":        # ml_dtypes array held in memory
        t = torch.from_numpy(v.view(np.uint16).view(np.int16)
                             ).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(v))      # a writable copy
    if dtype is not None and t.is_floating_point():
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
    ``_flatten(params)`` output.  ``dtype`` casts floating tensors (None
    keeps the stored dtype)."""
    pat = cfg.pattern
    n_per = len(pat)
    layers: List[Dict] = [dict() for _ in range(cfg.num_layers)]
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
        else:
            _set(out, parts, _to_tensor(val, dtype, device))
    if any(not lp for lp in layers):
        raise ValueError("checkpoint is missing layers for this config")
    out["layers"] = layers
    return out


def load_params(path: str, cfg: ModelConfig, *, device="cuda",
                dtype: Optional[torch.dtype] = None) -> Params:
    """Read a reference ``save_checkpoint`` file into port params."""
    return params_from_flat(load_flat(path), cfg, device=device, dtype=dtype)
