"""Cross-request prefix index: full prompt blocks -> physical pool blocks.

The paper's §4.4 argument — LoRA functions waste GPU memory on state that
could be shared — applies one level below the weights: requests hitting the
same adapter routinely share a system-prompt prefix, and the KV those
prefix tokens produce is identical (K/V at position *i* depends only on the
token prefix [0, i] and the adapter).  This index lets ``try_admit`` map
the physical blocks an earlier request already filled straight into a new
slot's block table instead of allocating and re-inserting them.

Structure: a hash-trie over *full* prompt blocks.  Each node is one block
of ``block_size`` token ids, keyed under its parent node — so a chain of
nodes is exactly a prompt prefix in block units, and lookup is a walk:
root key ``(adapter_idx, tokens[0:bs])``, then child key ``tokens[j*bs:
(j+1)*bs]`` per level.  Python dict keys compare exactly, so there are no
hash-collision false shares.  Only blocks *fully* covered by a prompt are
ever indexed: the partially-filled tail block (and the block the first
decode token lands in) stays private to its request, which is what makes
sharing copy-on-write-safe — decode writes can never touch an indexed
block (see ``runtime.try_admit``).

Lifecycle is owned by ``kv_pool.BlockPool``: the pool asks ``has_block``
whether a refcount-0 block's content is worth parking in the cached LRU,
and calls ``forget_block`` when it evicts one (or when ``reset`` clears
the pool).  Forgetting a mid-chain node orphans its descendants — they
become unreachable to ``match`` immediately and their own pool blocks age
out of the cached LRU like any other; ``forget_block`` drops their index
entries when that happens.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("phys", "parent", "edge", "children")

    def __init__(self, phys: int, parent: Optional["_Node"], edge: Tuple):
        self.phys = phys                    # physical pool block id
        self.parent = parent                # None = root level
        self.edge = edge                    # key under parent / roots
        self.children: Dict[Tuple[int, ...], "_Node"] = {}


class PrefixCache:
    """Trie of full prompt blocks keyed by (adapter, block-of-token-ids)."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        # root level keyed by (adapter_idx, first block's tokens)
        self._roots: Dict[Tuple, _Node] = {}
        self._by_phys: Dict[int, _Node] = {}

    def __len__(self) -> int:
        return len(self._by_phys)

    def has_block(self, phys: int) -> bool:
        """Is this physical block indexed?  (``BlockPool.cache_hook``.)"""
        return phys in self._by_phys

    @staticmethod
    def _full_blocks(tokens: Sequence[int], block_size: int) -> int:
        return len(tokens) // block_size

    def _edge(self, adapter: int, tokens, j: int,
              root: bool) -> Tuple:
        bs = self.block_size
        blk = tuple(int(t) for t in tokens[j * bs:(j + 1) * bs])
        return (adapter, blk) if root else blk

    # -------------------------------------------------------------- lookup
    def match(self, adapter: int, tokens
              ) -> Tuple[List[int], Optional[_Node]]:
        """Longest indexed chain of full prompt blocks for this prompt.

        Returns (physical block ids of the covered prefix, deepest matched
        node) — the node seeds ``register`` so the uncovered tail chains on
        without a second walk."""
        covered: List[int] = []
        node: Optional[_Node] = None
        for j in range(self._full_blocks(tokens, self.block_size)):
            edge = self._edge(adapter, tokens, j, root=node is None)
            nxt = self._roots.get(edge) if node is None \
                else node.children.get(edge)
            if nxt is None:
                break
            node = nxt
            covered.append(node.phys)
        return covered, node

    def covered_tokens(self, adapter: int, tokens) -> int:
        """Prompt tokens covered by the longest indexed chain — the prefix
        chunked paged prefill can skip recomputing.  Pure lookup (no
        refcount side effects): admission planning and TTFT estimation can
        ask before committing to an admit."""
        return len(self.match(adapter, tokens)[0]) * self.block_size

    # ------------------------------------------------------------ mutation
    def register(self, adapter: int, tokens, phys: Sequence[int],
                 covered: int, node: Optional[_Node]) -> List[int]:
        """Index this prompt's full blocks beyond the already-covered
        prefix.  ``phys[j]`` is the physical block holding positions
        [j*bs, (j+1)*bs); ``covered``/``node`` come from ``match``.

        Returns the newly indexed physical ids (rollback handle for a
        failed group admission).  A concurrent identical registration wins
        ties: if an edge already exists, the existing mapping is kept and
        this request's private copy simply stays unindexed."""
        new: List[int] = []
        for j in range(covered, self._full_blocks(tokens, self.block_size)):
            edge = self._edge(adapter, tokens, j, root=node is None)
            table = self._roots if node is None else node.children
            existing = table.get(edge)
            if existing is not None:
                node = existing
                continue
            child = _Node(int(phys[j]), node, edge)
            table[edge] = child
            self._by_phys[child.phys] = child
            new.append(child.phys)
            node = child
        return new

    def forget_block(self, phys: int) -> None:
        """Drop the node for an evicted/rolled-back physical block
        (``BlockPool.evict_hook``).  Descendants become unreachable and are
        forgotten individually as the pool evicts their blocks."""
        node = self._by_phys.pop(phys, None)
        if node is None:
            return
        table = self._roots if node.parent is None else node.parent.children
        if table.get(node.edge) is node:
            del table[node.edge]
