"""Checkpointing (port of ``repro/checkpoint/store.py``): flat-key npz
tensors + JSON metadata, in the reference's format, so either package
reads the other's files.

``_flatten`` joins the keys of nested dicts with ``/``, writes ``#i`` for
the items of a list or tuple (both read back as tuples) and
``__empty_tuple__`` for an empty one, and drops None leaves.  numpy has
no bfloat16, so a bfloat16 leaf is stored as its uint16 bits and tagged
``"bfloat16"`` in the JSON's ``dtypes``.

Doubles as the artifact-size ground truth for the serverless loading
model: ``checkpoint_manifest`` reports the byte sizes of the backbone and
the adapters, the artifacts the pre-loading scheduler moves.  A model
checkpoint in the reference's period-stacked layout comes from
``checkpoint/bridge.py::reference_tree``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.lora import partition_lora, tree_leaves
from repro_torch.serving.faults import retry_with_backoff

Params = Dict[str, Any]
_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    """Flat key -> leaf dict in the reference's key grammar."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}{_SEP}"))
    elif isinstance(tree, (tuple, list)):
        if not tree:
            out[f"{prefix}__empty_tuple__"] = np.zeros((0,), np.int8)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}#{i}{_SEP}"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    """Inverse of ``_flatten``: ``#i`` keys become tuples, a lone
    ``__empty_tuple__`` the empty tuple."""
    root: Dict = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def fix(node):
        if isinstance(node, dict) and list(node) == ["__empty_tuple__"]:
            return ()
        if isinstance(node, dict) and node and all(
                k.startswith("#") for k in node):
            return tuple(fix(node[f"#{i}"]) for i in range(len(node)))
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


def _to_numpy(leaf: Any) -> Tuple[np.ndarray, str]:
    """(the array to store, its dtype tag)."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def save_checkpoint(path: str, params: Any,
                    meta: Optional[Dict] = None) -> int:
    """Writes <path>.npz (+ .json metadata).  Returns bytes written."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tagged, dtypes = {}, {}
    for k, v in _flatten(params).items():
        tagged[k], dtypes[k] = _to_numpy(v)
    np.savez(path + ".npz", **tagged)
    with open(path + ".json", "w") as f:
        json.dump({"dtypes": dtypes, "meta": meta or {}}, f)
    return os.path.getsize(path + ".npz")


def load_checkpoint(path: str, *, retries: int = 0, backoff_s: float = 0.0,
                    sleep: Callable[[float], None] = time.sleep,
                    fault_hook: Optional[Callable[[str, str], None]] = None,
                    on_retry: Optional[Callable[[int, BaseException],
                                                None]] = None,
                    device="cuda") -> Tuple[Params, Dict]:
    """Read a checkpoint into tensors on ``device``, optionally retrying
    transient load failures.

    ``retries``/``backoff_s``/``sleep`` feed ``faults.retry_with_backoff``
    (``retries=0`` fails fast); ``fault_hook(target, name)`` — typically a
    bound ``FaultPlan.artifact_check`` — may veto each attempt by raising.
    Returns (the tree, with tuples where lists were saved and None leaves
    gone, and the metadata)."""

    def attempt() -> Tuple[Params, Dict]:
        if fault_hook is not None:
            fault_hook("checkpoint", path)
        with open(path + ".json") as f:
            info = json.load(f)
        flat = {}
        with np.load(path + ".npz") as z:
            for k in z.files:
                arr = z[k]
                if info["dtypes"].get(k) == "bfloat16":
                    t = torch.from_numpy(arr.view(np.int16)).view(
                        torch.bfloat16)
                else:
                    t = torch.from_numpy(arr)
                flat[k] = t.to(device)
        return _unflatten(flat), info.get("meta", {})

    return retry_with_backoff(attempt, retries=retries, backoff_s=backoff_s,
                              sleep=sleep, on_retry=on_retry)


def checkpoint_manifest(params: Params) -> Dict[str, int]:
    """Byte sizes of the separately-loadable artifacts (paper's
    taxonomy)."""
    backbone, adapters = partition_lora(params)

    def nbytes(tree) -> int:
        return int(sum(x.numel() * x.element_size()
                       for x in tree_leaves(tree)))

    return {"backbone_bytes": nbytes(backbone),
            "adapter_bytes": nbytes(adapters),
            "total_bytes": nbytes(params)}
