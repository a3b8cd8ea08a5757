"""Live adapter registry: load/unload/swap LoRA adapters under a running
runtime (port of ``repro/serving/adapters.py``).

The paper's cost argument is that per-function model copies duplicate
99 % of their bytes; the fix is ONE resident backbone plus a
fixed-capacity stacked adapter bank that functions are loaded into and
evicted from while the runtime keeps serving.  This module is that
lifecycle:

* The bank is the ``(N, D, r)`` / ``(N, r, O)`` LoRA leaves already inside
  ``runtime.params`` (``core.lora``).  Its capacity N is FIXED at
  construction — loading adapter number N+1 means evicting one first.
* ``load``/``swap`` write an adapter's weights into a bank slot IN PLACE:
  ``bank_leaf[..., slot, :, :].copy_(padded)`` on the current stream,
  into the same storage.  This is the one deliberate difference from the
  reference, which rebinds ``runtime.params`` to a new functional tree:
  the runtime's captured CUDA graphs hold the bank's addresses, so after
  any ``load``, ``swap`` or ``unload`` every LoRA leaf's ``data_ptr()``
  stays as it was, and churn never recaptures anything.  A write is
  stream-ordered after every dispatch issued before it.  Adapters with a
  smaller rank than the bank are zero-padded up to it: padded rank columns
  contribute exactly zero to the delta.
* Slot ids are recycled through a LIFO free list; names are the public
  API (``ServeRequest.adapter``), slots are the runtime's internal
  currency (``SlotState.adapter``, the decode dispatch vector).
* In-flight requests PIN their slot (``runtime.try_admit`` pins on bind,
  ``runtime._release_slot`` unpins on finish/force-evict).
  ``unload``/``swap`` refuse pinned slots: mutating weights a live decode
  row still reads would change that request's results mid-stream.
* ``unload``/``swap`` purge the slot's prefix-cache subtree and return the
  parked pool blocks to the free list: the trie is adapter-keyed, so K/V
  produced under the old weights must be unreachable the moment the slot
  can mean different weights.

The registry never zeroes an unloaded slot's bank weights: admission
rejects unresolved/unloaded adapters (``rejected_unknown_adapter``), and
inactive decode rows' deltas are discarded, so stale slot contents are
unreachable by construction.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.lora import _zip_map, partition_lora, tree_leaves
from repro_torch.serving.faults import retry_with_backoff


def _pad_leaf(ad: torch.Tensor, target_shape) -> torch.Tensor:
    """Zero-pad an adapter leaf up to the bank's per-slot shape (rank
    columns for "a" leaves, rank rows for "b" leaves)."""
    if tuple(ad.shape) == tuple(target_shape):
        return ad
    if ad.dim() != len(target_shape) or any(
            s > t for s, t in zip(ad.shape, target_shape)):
        raise ValueError(
            f"adapter leaf shape {tuple(ad.shape)} exceeds bank slot "
            f"shape {tuple(target_shape)}")
    out = ad.new_zeros(target_shape)
    out[tuple(slice(0, s) for s in ad.shape)] = ad
    return out


def _as_tensor(ad: Any) -> torch.Tensor:
    return ad if isinstance(ad, torch.Tensor) else torch.from_numpy(
        np.asarray(ad))


class AdapterRegistry:
    """Name -> bank-slot lifecycle over a live ``ContinuousRuntime``.

    Construction attaches the registry to the runtime (``runtime.adapters``)
    so admission resolves ``ServeRequest.adapter`` names through it.
    ``names`` marks bank slots ``0..len(names)-1`` as already loaded with
    the weights the params tree was built with."""

    def __init__(self, runtime, *, names: Optional[Sequence[str]] = None):
        if runtime.bank_slots is None:
            raise ValueError(
                "runtime params carry no LoRA bank — build them with "
                "init_params(..., lora_adapters=N) / stack_adapters first")
        cap = runtime.scfg.adapters.max_live
        if cap is None:
            cap = runtime.bank_slots
        if not 0 < cap <= runtime.bank_slots:
            raise ValueError(
                f"max_live_adapters {cap} must be in [1, bank capacity "
                f"{runtime.bank_slots}]")
        self.runtime = runtime
        self.capacity = int(cap)
        rank = runtime.scfg.adapters.lora_rank
        if rank is not None and runtime.cfg.lora is not None \
                and rank != runtime.cfg.lora.rank:
            raise ValueError(
                f"AdapterConfig.lora_rank {rank} != bank rank "
                f"{runtime.cfg.lora.rank}")
        self._by_name: Dict[str, int] = {}
        self._names: Dict[int, str] = {}
        self._free: List[int] = list(range(self.capacity - 1, -1, -1))
        self._pins: Dict[int, int] = {}
        names = list(names or [])
        if len(names) > self.capacity:
            raise ValueError(
                f"{len(names)} preloaded names exceed capacity "
                f"{self.capacity}")
        if len(set(names)) != len(names):
            raise ValueError("duplicate preloaded adapter names")
        for name in names:
            slot = self._free.pop()
            self._by_name[name] = slot
            self._names[slot] = name
        for cname, chelp in (
                ("adapter_loads", "adapters written into bank slots"),
                ("adapter_swaps", "in-place weight replacements"),
                ("adapter_unloads", "bank slots returned to the free "
                 "list (prefix subtree purged)")):
            runtime.metrics.counter(cname, chelp)
        runtime.adapters = self

    # --------------------------------------------------------------- views
    def __len__(self) -> int:
        return len(self._by_name)

    def names(self) -> List[str]:
        return sorted(self._by_name)

    def resolve(self, name: str) -> Optional[int]:
        """Registry name -> bank slot; None when not loaded (admission
        turns that into a graceful ``rejected_unknown_adapter``)."""
        return self._by_name.get(name)

    def slot_of(self, name: str) -> int:
        slot = self._by_name.get(name)
        if slot is None:
            raise KeyError(f"adapter {name!r} is not loaded")
        return slot

    def slot_loaded(self, slot: int) -> bool:
        return slot in self._names

    def pinned(self, name: str) -> int:
        """Live pin count for a loaded adapter (0 = safe to unload)."""
        return self._pins.get(self.slot_of(name), 0)

    def pin_counts(self) -> Dict[int, int]:
        """Pin count per bank slot — ``runtime.check_invariants`` compares
        this against the active slots' per-adapter holders to catch pin
        leaks / double-unpins on any exit path."""
        return dict(self._pins)

    # ---------------------------------------------------------------- pins
    def pin(self, slot: int) -> None:
        self._pins[slot] = self._pins.get(slot, 0) + 1

    def unpin(self, slot: int) -> None:
        left = self._pins.get(slot, 0) - 1
        if left < 0:
            raise RuntimeError(f"unpin of unpinned bank slot {slot}")
        if left:
            self._pins[slot] = left
        else:
            self._pins.pop(slot, None)

    # ----------------------------------------------------------- lifecycle
    def load(self, name: str, adapter_tree) -> int:
        """Write an adapter (a single-adapter LoRA tree: the params
        structure with None off the LoRA leaves and (D, r) / (r, O) leaves
        on them, e.g. from ``core.lora.take_adapter``) into a free bank
        slot under ``name``.  Raises when the name is taken (use ``swap``)
        or every slot is loaded (unload a victim first — eviction POLICY
        lives with the caller, the registry is mechanism)."""
        if name in self._by_name:
            raise ValueError(f"adapter {name!r} already loaded; use swap()")
        if not self._free:
            raise RuntimeError(
                f"adapter bank full ({self.capacity} slots) — unload one "
                f"first")
        slot = self._free.pop()
        try:
            self._store_retrying(slot, adapter_tree, name)
        except BaseException:
            # rollback: a failed load must leave the registry exactly as
            # it was — the slot returns to the free list unnamed
            self._free.append(slot)
            raise
        self._by_name[name] = slot
        self._names[slot] = name
        self._event("adapter_loads", "adapter:load", name, slot)
        return slot

    def swap(self, name: str, adapter_tree) -> int:
        """Replace a loaded adapter's weights in place (same name, same
        slot).  Refused while pinned; purges the slot's prefix subtree —
        K/V computed under the old weights must not serve the new ones."""
        slot = self.slot_of(name)
        self._check_unpinned(name, slot, "swap")
        self._store_retrying(slot, adapter_tree, name)
        self._purge_prefix(slot)
        self._event("adapter_swaps", "adapter:swap", name, slot)
        return slot

    def unload(self, name: str) -> int:
        """Return ``name``'s slot to the free list.  Refused while any
        admitted request still runs on it.  The slot's prefix-cache
        subtree is dropped and its parked pool blocks freed, so a future
        tenant of the slot can never hit stale K/V."""
        slot = self.slot_of(name)
        self._check_unpinned(name, slot, "unload")
        del self._by_name[name]
        del self._names[slot]
        self._free.append(slot)
        self._purge_prefix(slot)
        self._event("adapter_unloads", "adapter:unload", name, slot)
        return slot

    # ------------------------------------------------------------ internals
    def _check_unpinned(self, name: str, slot: int, op: str) -> None:
        pins = self._pins.get(slot, 0)
        if pins:
            raise RuntimeError(
                f"cannot {op} adapter {name!r}: {pins} in-flight "
                f"request(s) pin bank slot {slot}")

    def _store_retrying(self, slot: int, adapter_tree, name: str) -> None:
        """``_store`` behind the shared retry primitive.  An attached fault
        plan (``runtime.faults``) gets to veto each attempt; transient
        failures are retried ``robust.artifact_retries`` times with
        exponential backoff and counted in ``artifact_retries``.  The
        final failure propagates — callers (``load``) roll back their
        registry state."""
        rt = self.runtime
        rcfg = rt.scfg.robust

        def attempt():
            if rt.faults is not None:
                rt.faults.artifact_check("adapter", name)
            self._store(slot, adapter_tree)

        def on_retry(_attempt: int, _exc: BaseException) -> None:
            rt.stats["artifact_retries"] += 1

        retry_with_backoff(attempt, retries=rcfg.artifact_retries,
                           backoff_s=rcfg.artifact_backoff_s,
                           on_retry=on_retry)

    def _store(self, slot: int, adapter_tree) -> None:
        """Every leaf is cast, padded and checked before the first write,
        so a malformed tree leaves the bank untouched."""
        _, bank = partition_lora(self.runtime.params)
        pairs: List = []
        _zip_map(lambda bk, ad: None if bk is None else pairs.append(
            (bk, _pad_leaf(_as_tensor(ad).to(device=bk.device,
                                              dtype=bk.dtype),
                           bk.shape[:-3] + bk.shape[-2:]))),
                 bank, adapter_tree)
        if len(pairs) != len(tree_leaves(bank)):
            raise ValueError("adapter tree does not cover every bank leaf")
        for bk, ad in pairs:
            bk[..., slot, :, :].copy_(ad)

    def _purge_prefix(self, slot: int) -> None:
        rt = self.runtime
        if rt.prefix is None:
            return
        dropped = rt.prefix.forget_adapter(slot)
        if dropped:
            rt.pool.drop_cached(dropped)

    def _event(self, counter: str, span: str, name: str, slot: int) -> None:
        rt = self.runtime
        rt.stats[counter] += 1
        if rt.telemetry is not None:
            t = rt._timer()
            rt.telemetry.instant(span, "host", t, adapter=name, slot=slot,
                                 pool_cached=rt.pool.num_cached)
