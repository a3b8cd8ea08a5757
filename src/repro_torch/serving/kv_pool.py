"""Host-side paged KV-cache block manager with a refcounted lifecycle.

The device-side pools (``models.cache.init_paged_cache``) are dumb arrays;
this manager owns which physical blocks are free, who holds them, and which
freed blocks still carry reusable content.  A block moves through three
states:

    free ──alloc──▶ live (refcount >= 1) ──free to 0──▶ cached ──evict──▶ free
                      ▲                                    │
                      └──────────── share ─────────────────┘

* **live** — referenced by one or more decode slots.  Prefix sharing maps
  the same physical block into several slots' block tables (``share`` bumps
  the refcount); ``free`` decrements and only the last holder actually
  releases the block.
* **cached** — refcount reached 0 but the block's content is still valid
  for cross-request prefix reuse (``cache_hook`` said so — the runtime
  wires it to ``PrefixCache.has_block``).  Cached blocks stay allocatable:
  ``alloc`` evicts them LRU-first when the free list runs dry, notifying
  ``evict_hook`` so the prefix index drops the mapping.

Allocation is all-or-nothing (a request either gets every block it asked
for or none), so a failed admission has no cleanup path.  Physical block 0
is the reserved *garbage* block (``models.cache.GARBAGE_BLOCK``): inactive
or stalled decode rows write there and the position mask guarantees it is
never read back, so it is never handed out.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.models.cache import GARBAGE_BLOCK


def blocks_for_tokens(n_tokens: int, block_size: int) -> int:
    """Blocks needed to hold token positions [0, n_tokens)."""
    if n_tokens <= 0:
        return 0
    return (n_tokens + block_size - 1) // block_size


class BlockPool:
    """Refcounted lifecycle manager over physical block ids [1, num_blocks).

    ``in_use`` counts *live* blocks only; cached blocks are reusable
    capacity and count toward ``available``.  ``high_water`` tracks the
    peak live-block count — the pool-pressure metric sliding-window
    reclamation and prefix sharing exist to shrink.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the garbage block)")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO free-list, low ids first out — recently-freed blocks are
        # recycled immediately (the gather does not care about locality)
        self._free: List[int] = list(range(num_blocks - 1, GARBAGE_BLOCK, -1))
        self._ref: Dict[int, int] = {}
        # refcount-0 blocks whose content is still shareable, oldest first
        self._cached: "OrderedDict[int, None]" = OrderedDict()
        # runtime wiring (both optional — a bare pool is a plain free list):
        # cache_hook(id) -> bool: keep this freed block's content for reuse?
        # evict_hook(id): a cached block is being repurposed, drop its index
        self.cache_hook: Optional[Callable[[int], bool]] = None
        self.evict_hook: Optional[Callable[[int], None]] = None
        self.high_water = 0

    @property
    def available(self) -> int:
        """Allocatable blocks: the free list plus evictable cached blocks."""
        return len(self._free) + len(self._cached)

    @property
    def in_use(self) -> int:
        """Live blocks (refcount >= 1)."""
        return len(self._ref)

    @property
    def num_free(self) -> int:
        """Free-list blocks only (``available`` minus evictable cached
        blocks) — the pool-occupancy gauge the metrics registry samples."""
        return len(self._free)

    @property
    def num_cached(self) -> int:
        return len(self._cached)

    def refcount(self, block_id: int) -> int:
        return self._ref.get(block_id, 0)

    def is_cached(self, block_id: int) -> bool:
        return block_id in self._cached

    def _note_high_water(self) -> None:
        if len(self._ref) > self.high_water:
            self.high_water = len(self._ref)

    # ----------------------------------------------------------- lifecycle
    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh blocks at refcount 1, or None if the pool cannot
        cover all of them.  Draws from the free list first, then evicts
        cached blocks LRU-first (notifying ``evict_hook``)."""
        if n < 0:
            raise ValueError(n)
        if n > self.available:
            return None
        ids: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, _ = self._cached.popitem(last=False)
                if self.evict_hook is not None:
                    self.evict_hook(b)
            self._ref[b] = 1
            ids.append(b)
        self._note_high_water()
        return ids

    def share(self, ids: Sequence[int]) -> None:
        """Add one reference to each block — prefix sharing maps an existing
        block into another slot's table.  Live blocks get refcount + 1;
        cached blocks revive to refcount 1.  Atomic: validated before any
        mutation (sharing a free/unknown block is a bug, not a warning)."""
        bad = [b for b in ids
               if self._ref.get(b, 0) < 1 and b not in self._cached]
        if bad:
            raise KeyError(f"share of free/unknown block(s) {bad}")
        if len(set(ids)) != len(ids):
            raise KeyError(f"duplicate block id in share list {list(ids)}")
        for b in ids:
            if b in self._cached:
                del self._cached[b]
                self._ref[b] = 1
            else:
                self._ref[b] += 1
        self._note_high_water()

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per block; the LAST release actually frees.

        A block that reaches refcount 0 returns to the free list, unless
        ``cache_hook`` claims its content (prefix-indexed prompt blocks) —
        then it parks in the cached LRU, still allocatable via eviction.

        Releasing a block you do not hold a reference to (double-release,
        foreign id, duplicate in one call) is a bug, not a warning.
        Atomic: the whole id list is validated before any mutation, so a
        caller that catches the KeyError observes an unchanged pool (a
        partial free would leak the valid prefix AND corrupt refcounts)."""
        bad = [b for b in ids if self._ref.get(b, 0) < 1]
        if bad:
            raise KeyError(f"free of unreferenced block(s) {bad}")
        if len(set(ids)) != len(ids):
            raise KeyError(f"duplicate block id in free list {list(ids)}")
        for b in ids:
            r = self._ref[b] - 1
            if r > 0:
                self._ref[b] = r
                continue
            del self._ref[b]
            if self.cache_hook is not None and self.cache_hook(b):
                self._cached[b] = None          # most-recently-used at end
            else:
                self._free.append(b)

    def drop_cached(self, ids: Sequence[int]) -> List[int]:
        """Return specific CACHED blocks straight to the free list, without
        firing ``evict_hook`` (the caller already dropped the index — this
        is the pool half of ``AdapterRegistry``'s prefix purge).  Ids that
        are not cached (already free, or live under some slot) are
        skipped; returns the ids actually moved."""
        moved: List[int] = []
        for b in ids:
            if b in self._cached:
                del self._cached[b]
                self._free.append(b)
                moved.append(b)
        return moved

    def reset(self) -> None:
        """Reinitialize to all-free.  Live (refcount >= 1) blocks mean some
        slot still maps them — resetting underneath it would hand the same
        physical block to two owners, so that is an error, not a cleanup.
        Cached blocks are owner-less and are evicted (``evict_hook`` fires
        so the prefix index cannot resurrect stale mappings)."""
        if self._ref:
            raise RuntimeError(
                f"reset with {len(self._ref)} live refcounted block(s) "
                f"{sorted(self._ref)[:8]} — release every slot first")
        if self.evict_hook is not None:
            for b in self._cached:
                self.evict_hook(b)
        self._cached.clear()
        self._free = list(range(self.num_blocks - 1, GARBAGE_BLOCK, -1))
        self.high_water = 0
