"""Multi-LoRA inference steps over a shared backbone (port of
``repro/core/engine.py``): the warm-function ``InferenceEngine`` over ring
caches (attention rings and REC/SSD ring state), the serving steps over the
paged pools and slot-state rows, and the slot-wise REC/SSD state ops.

The reference builds pure functions that it jits; the factories here
return plain functions that update the caches in place (the stand-in for
the reference's donated cache).  The serving runtime and the engine's
decode loop capture them as CUDA graphs (``serving.graphs``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models import cache as cache_lib
from repro_torch.models import transformer as tf
from repro_torch.models.config import ATTN, ModelConfig

Params = Dict[str, Any]


def make_prefill_step(cfg: ModelConfig):
    """(params, tokens, cache [, embeds/frame_embeds, adapter_idx,
    last_pos]) -> (last-token logits (B, V), filled ring cache).  embeds:
    (B, P, D) a VLM's image-prefix embeddings before the tokens (prefix-LM
    mask); frame_embeds: (B, encoder_seq, D) an encoder-decoder's audio
    frames, encoded into the cross caches; last_pos: (B,) per-row index of
    the true last prompt token (counted from the first prefix position);
    without it the last position's logit feeds the LM head alone."""

    def prefill_step(params, tokens, cache, *, embeds=None,
                     frame_embeds=None, adapter_idx=None, last_pos=None):
        logits, cache = tf.forward(params, cfg, tokens, cache=cache,
                                   embeds=embeds, frame_embeds=frame_embeds,
                                   adapter_idx=adapter_idx,
                                   last_only=last_pos is None,
                                   last_pos=last_pos)
        return logits[:, -1], cache

    return prefill_step


def make_chunked_prefill_step(cfg: ModelConfig):
    """One fixed-shape slice of chunked paged prefill — the serving join
    path.  Processes ``tokens`` (B, C) at positions ``start[b] + [0, C)``,
    writing K/V straight into pool blocks (``chunk_ids`` (B, C//bs);
    garbage-block entries skip the write) and attending over each row's
    paged history via ``block_tbl`` (B, MB).  ``last_idx`` (B,) is the
    in-chunk index whose logit to return; ``state_rows`` (B,) names each
    row's REC/SSD slot-state row.  Returns ((B, V) logits, pools and state
    rows updated in place)."""

    def chunked_prefill_step(params, tokens, start, last_idx, cache,
                             chunk_ids, block_tbl, *, adapter_idx=None,
                             state_rows=None):
        logits, cache = tf.forward(
            params, cfg, tokens, cache=cache, adapter_idx=adapter_idx,
            start_pos=start, last_pos=last_idx, block_tbl=block_tbl,
            chunk_ids=chunk_ids, state_rows=state_rows)
        return logits[:, -1], cache

    return chunked_prefill_step


def make_serve_step(cfg: ModelConfig):
    """ONE-token decode.  On a ring cache ``pos`` is the scalar position of
    every row; on the paged pools it is (B,) per-slot positions,
    ``block_tbl`` (B, MB) maps each slot's logical blocks to pool blocks
    and ``state_rows`` (B,) names each row's REC/SSD slot-state row."""

    def serve_step(params, token, cache, pos, *, adapter_idx=None,
                   block_tbl=None, state_rows=None):
        return tf.decode_step(params, cfg, token, cache, pos,
                              adapter_idx=adapter_idx, block_tbl=block_tbl,
                              state_rows=state_rows)

    return serve_step


# ------------------------------------------------------- slot-wise cache ops
def make_insert_fn(cfg: ModelConfig, block_size: int):
    """Slot-wise cache *insert*: copy a prefilled ring cache (``init_cache``
    layout, rows of S = nb x bs slots) into pool blocks, in place.
    ``block_ids``: (G, nb) physical block ids per row; an id equal to the
    garbage block (0) sends that slab to block 0, which the decode mask
    never reads (right-padding past a row's prompt, prefix-shared blocks
    already written).  The legacy bucket-and-scatter oracle that the
    chunked paged prefill is held against; the serving path never calls
    it.  Returns (pool_cache, prefill_cache, block_ids) -> pool_cache,
    the pools written in place.  Layers without pools (REC/SSD state rows)
    are left alone.  Slabs are written row by row, block by block, so
    where ids repeat (the garbage block) the last write lands, as the
    reference's scatter on the CPU leaves it."""

    def insert(pool_cache, prefill_cache, block_ids: torch.Tensor):
        ids = block_ids.long()
        G, nb = ids.shape
        for pool_l, pre_l in zip(pool_cache, prefill_cache):
            if "kp" not in pool_l:
                continue
            for src, dst in (("k", "kp"), ("v", "vp")):
                x = pre_l[src]                            # (G, S, K, hd)
                K, hd = x.shape[2], x.shape[3]
                # (G, nb, bs, K, hd) -> heads-major (K, G, nb, bs, hd)
                xr = x.reshape(G, nb, block_size, K, hd).permute(3, 0, 1, 2,
                                                                 4)
                pool = pool_l[dst]
                for g in range(G):
                    for j in range(nb):
                        pool[:, ids[g, j]] = xr[:, g, j].to(pool.dtype)
        return pool_cache

    return insert


def make_extract_fn(cfg: ModelConfig, block_size: int):
    """Slot-wise cache *extract*, the inverse of insert (for tests and
    migration): one slot's blocks gathered back into contiguous K/V.
    (pool_cache, block_ids (nb,)) -> one entry per layer: {"k", "v":
    (nb x bs, K, hd)} copies for a pooled layer, None for the others."""

    def extract(pool_cache, block_ids: torch.Tensor):
        ids = block_ids.long()
        nb = ids.shape[0]
        out: List[Optional[Dict[str, torch.Tensor]]] = []
        for pool_l in pool_cache:
            if "kp" not in pool_l:
                out.append(None)
                continue
            ent = {}
            for src, name in (("kp", "k"), ("vp", "v")):
                t = pool_l[src][:, ids]                 # (K, nb, bs, hd)
                ent[name] = t.permute(1, 2, 0, 3).reshape(
                    nb * block_size, t.shape[0], t.shape[3]).contiguous()
            out.append(ent)
        return out

    return extract


# --------------------------------------------------- slot-wise state ops
# REC/SSD layers keep their serving state in dense per-slot rows
# (models.cache.slot_state_spec).  The runtime never dispatches these: a
# prefill chunk at position 0 zeroes a recycled row in-step and every step
# scatters its own updates.  They exist for tests, migration and slot
# snapshot/restore.  The port's cache is a list in stack order, so a
# state tree is one entry per layer: a {name: tensor} dict for REC/SSD
# layers, None for ATTN layers (their K/V lives in pool blocks).
def make_state_extract_fn(cfg: ModelConfig):
    """(cache, row) -> per-layer copies of slot ``row``'s REC/SSD state."""

    def extract(cache, row: int) -> List[Optional[Dict[str, torch.Tensor]]]:
        return [None if kind == ATTN else
                {k: t[row].clone() for k, t in layer.items()}
                for kind, layer in zip(cfg.layer_kinds, cache)]

    return extract


def make_state_insert_fn(cfg: ModelConfig):
    """(cache, states, row) -> cache with slot ``row``'s REC/SSD state set
    from ``states`` (the extract layout; ATTN entries ignored), in
    place."""

    def insert(cache, states, row: int):
        for kind, layer, st in zip(cfg.layer_kinds, cache, states):
            if kind != ATTN:
                for k, t in layer.items():
                    t[row] = st[k].to(t.dtype)
        return cache

    return insert


def make_state_reset_fn(cfg: ModelConfig):
    """(cache, rows (R,)) -> cache with those REC/SSD rows zeroed in place
    (ATTN pools untouched)."""

    def reset(cache, rows: torch.Tensor):
        for kind, layer in zip(cfg.layer_kinds, cache):
            if kind != ATTN:
                for t in layer.values():
                    t.index_fill_(0, rows.long().to(t.device), 0)
        return cache

    return reset


class InferenceEngine:
    """Warm-function inference over a shared backbone, on ring caches
    (K/V rings of the attention layers, the recurrent state of REC/SSD
    layers).

    params: full tree whose LoRA leaves are stacked (N, ...) multi-adapter
    banks (``core.lora.stack_adapters``); requests carry adapter indices.
    Prefill attention runs the flash kernel, decode attention the
    ring-decode kernel, every LoRA site SGMV (on the card; the plain
    versions for ``device="cpu"``).

    ``generate`` keeps one ring per (batch, context length) and one decode
    step for it, captured once as a CUDA graph on the card (the reference
    jits its decode scan per batch shape) and replayed for every token;
    prefill stays eager, since its prompt length varies.
    """

    def __init__(self, cfg: ModelConfig, params: Params, *,
                 max_context: int = 2048, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_context = max_context
        self.device = torch.device(device)
        self._prefill = make_prefill_step(cfg)
        self._decode = make_serve_step(cfg)
        self._pool = (torch.cuda.graph_pool_handle()
                      if self.device.type == "cuda" else None)
        # (batch, context length) -> (ring, its GraphedDispatch step)
        self._rings: Dict[Tuple[int, int], Tuple[List[Dict[str, Any]],
                                                 Any]] = {}

    def new_cache(self, batch: int,
                  context_len: Optional[int] = None) -> List[Dict[str, Any]]:
        return tf.init_cache(self.cfg, batch,
                             context_len or self.max_context,
                             device=self.device)

    def prefill(self, tokens: torch.Tensor,
                adapter_idx: Optional[torch.Tensor] = None,
                cache: Optional[List[Dict[str, Any]]] = None, *,
                embeds: Optional[torch.Tensor] = None,
                frame_embeds: Optional[torch.Tensor] = None):
        """tokens: (B, T) int; adapter_idx: (B,) int32 or None; embeds:
        (B, P, D) image-prefix embeddings or None; frame_embeds: (B,
        encoder_seq, D) audio frames or None.  A given cache must be fresh
        (``idx`` 0), else ValueError."""
        if cache is None:
            cache = self.new_cache(tokens.shape[0])
        return self._prefill(self.params, tokens, cache, embeds=embeds,
                             frame_embeds=frame_embeds,
                             adapter_idx=adapter_idx)

    @torch.no_grad()
    def _ring_step(self, cache: List[Dict[str, Any]], tok: torch.Tensor,
                   pos: torch.Tensor,
                   adapter_idx: Optional[torch.Tensor]) -> torch.Tensor:
        """One greedy decode step that advances its own inputs in place:
        the next tokens into ``tok``, ``pos + 1`` into the 0-d ``pos``."""
        logits, _ = self._decode(self.params, tok, cache, pos,
                                 adapter_idx=adapter_idx)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        tok.copy_(nxt)
        pos.add_(1)
        return nxt

    def ring(self, batch: int) -> Tuple[List[Dict[str, Any]], Any]:
        """The ring of this batch size, emptied to a fresh cache (idx 0,
        every slot -1, K/V, cross K/V and REC/SSD state zero), and its
        decode step: a ``GraphedDispatch`` called as ``step(tok, pos,
        adapter_idx)`` and then ``step.replay()``, each call returning the
        next (B,) tokens and advancing ``tok`` and the 0-d ``pos`` in
        place."""
        # imported here: the serving package imports this module
        from repro_torch.serving.graphs import GraphedDispatch
        key = (batch, self.max_context)
        if key not in self._rings:
            cache = self.new_cache(batch)
            # the REC/SSD ring state that the step advances in place
            state = [t for kind, layer in zip(self.cfg.layer_kinds, cache)
                     if kind != ATTN for k, t in layer.items() if k != "idx"]
            self._rings[key] = (cache, GraphedDispatch(
                functools.partial(self._ring_step, cache), self.device,
                pool=self._pool, keep=state))
            return self._rings[key]
        cache, step = self._rings[key]
        cache_lib.reset_ring(cache)
        return cache, step

    def captures(self) -> Dict[Tuple[int, int], int]:
        """Decode-step captures per (batch, context length) key."""
        return {k: step._cache_size() for k, (_, step) in self._rings.items()}

    def generate(self, tokens: torch.Tensor, max_new_tokens: int,
                 adapter_idx: Optional[torch.Tensor] = None, *,
                 embeds: Optional[torch.Tensor] = None,
                 frame_embeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """Greedy generation, after an image prefix ``embeds`` (B, P, D)
        where one is given, over audio frames ``frame_embeds`` (B,
        encoder_seq, D) where given (their K/V go into the ring's cross
        caches, which every decode step reads).  Returns ((B,
        max_new_tokens) int32, cache);
        the cache is the engine's ring for this batch size, valid until the
        next ``generate`` of that size.

        The reference's ``lax.scan`` becomes ``max_new_tokens - 1`` calls
        of one decode step at a 0-d device position: the first stages its
        inputs (capturing the step on the card the first time), the rest
        replay it on the tokens and position it advanced itself, so the
        loop never waits on the card."""
        B = tokens.shape[0]
        T = tokens.shape[1] + (embeds.shape[1] if embeds is not None else 0)
        cache, step = self.ring(B)
        logits, cache = self.prefill(tokens, adapter_idx, cache=cache,
                                     embeds=embeds,
                                     frame_embeds=frame_embeds)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok]
        if max_new_tokens > 1:
            pos = torch.full((), T, dtype=torch.int32, device=self.device)
            out.append(step(tok, pos, adapter_idx))
            out += [step.replay() for _ in range(max_new_tokens - 2)]
        for layer in cache:        # a replay runs no Python: count here
            layer["idx"] = T + max_new_tokens - 1
        return torch.stack(out, dim=1), cache

    def decode_one(self, token: torch.Tensor, cache: List[Dict[str, Any]],
                   pos, adapter_idx: Optional[torch.Tensor] = None):
        return self._decode(self.params, token, cache, pos,
                            adapter_idx=adapter_idx)
