"""Backbone LLM sharing across isolated LoRA functions (paper §4.4; port of
``repro/core/sharing.py``).

The backbone's static tensors live once in a :class:`BackboneStore`; each
serverless function gets a :class:`BackboneHandle` — a zero-copy reference
(the same tensors, refcounted), never a copy.  Dynamic state (KV cache,
adapter weights, activations) is private per :class:`FunctionInstance`,
matching the paper's isolation requirement: computations run with the
function's own resources; only the static data layer is shared.

Zero-copy holds by construction: handles return the identical tensor
objects (``a is b``, equal ``data_ptr()``; the tests assert both).  Unlike
the reference's ``jax.Array``, a torch tensor is mutable: the store does
not stop an in-place write to a shared backbone tensor, and nothing in the
port makes one — the engine writes only to its own caches.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

from repro_torch.core.lora import combine_lora, partition_lora, tree_leaves
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


class BackboneHandle:
    """Zero-copy view of a shared backbone.  Analogous to an opened CUDA IPC
    handle: grants read access to the weight tensors, nothing else."""

    def __init__(self, store: "BackboneStore", backbone_id: str):
        self._store = store
        self.backbone_id = backbone_id
        self._closed = False

    @property
    def params(self) -> Params:
        if self._closed:
            raise RuntimeError("handle closed")
        return self._store._entries[self.backbone_id].params

    @property
    def config(self) -> ModelConfig:
        return self._store._entries[self.backbone_id].config

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._store._release(self.backbone_id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass
class _Entry:
    config: ModelConfig
    params: Params          # backbone only (lora leaves are None)
    refcount: int = 0
    nbytes: int = 0
    loaded_at: float = 0.0


class BackboneStore:
    """Registry of shared backbones, one entry per backbone id.

    ``register`` strips any adapter leaves (the backbone must be pure) and
    records its byte size for the offloader.  ``open`` hands out refcounted
    zero-copy handles; ``evict`` refuses while handles are live unless
    forced (the Dynamic Offloader only evicts idle backbones)."""

    def __init__(self):
        self._entries: Dict[str, _Entry] = {}

    def register(self, backbone_id: str, config: ModelConfig,
                 params: Params) -> None:
        if backbone_id in self._entries:
            raise ValueError(f"backbone {backbone_id!r} already registered")
        backbone, _ = partition_lora(params)
        nbytes = sum(x.numel() * x.element_size()
                     for x in tree_leaves(backbone))
        self._entries[backbone_id] = _Entry(
            config=config, params=backbone, nbytes=nbytes,
            loaded_at=time.monotonic())

    def open(self, backbone_id: str) -> BackboneHandle:
        e = self._entries[backbone_id]
        e.refcount += 1
        return BackboneHandle(self, backbone_id)

    def _release(self, backbone_id: str) -> None:
        self._entries[backbone_id].refcount -= 1

    def refcount(self, backbone_id: str) -> int:
        return self._entries[backbone_id].refcount

    def nbytes(self, backbone_id: str) -> int:
        return self._entries[backbone_id].nbytes

    def evict(self, backbone_id: str, *, force: bool = False) -> bool:
        e = self._entries.get(backbone_id)
        if e is None:
            return False
        if e.refcount > 0 and not force:
            return False
        del self._entries[backbone_id]
        return True

    def ids(self) -> List[str]:
        return list(self._entries)

    def total_bytes(self) -> int:
        return sum(e.nbytes for e in self._entries.values())


class FunctionInstance:
    """One serverless LoRA function: private adapter + private decode
    state, shared (read-only) backbone via a handle.  The isolation
    boundary of the paper — each instance only ever mutates its own
    members."""

    def __init__(self, fn_id: str, handle: BackboneHandle, adapters: Params,
                 adapter_index: Optional[int] = None):
        self.fn_id = fn_id
        self._handle = handle
        self.adapters = adapters          # private
        self.adapter_index = adapter_index
        self.cache: Optional[Any] = None  # private KV cache

    @property
    def config(self) -> ModelConfig:
        return self._handle.config

    @property
    def params(self) -> Params:
        """Full parameter tree: shared backbone + private adapters,
        recombined WITHOUT copying backbone leaves."""
        return combine_lora(self._handle.params, self.adapters)

    def close(self) -> None:
        self._handle.close()
