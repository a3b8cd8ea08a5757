"""Multi-LoRA inference steps over a shared backbone (port of the
attention-stack subset of ``repro/core/engine.py``): the warm-function
``InferenceEngine`` over ring caches, and the serving steps over the paged
pools.

The reference builds pure functions that it jits; PyTorch runs eagerly, so
the factories here return plain functions that update the caches in place
(the stand-in for the reference's donated cache).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.sampling import sample_tokens
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


def make_prefill_step(cfg: ModelConfig):
    """(params, tokens, cache [, adapter_idx, last_pos]) -> (last-token
    logits (B, V), filled ring cache).  last_pos: (B,) per-row index of the
    true last prompt token; without it the last position's logit feeds the
    LM head alone."""

    def prefill_step(params, tokens, cache, *, adapter_idx=None,
                     last_pos=None):
        logits, cache = tf.forward(params, cfg, tokens, cache=cache,
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
    in-chunk index whose logit to return.  Returns ((B, V) logits, pools
    updated in place)."""

    def chunked_prefill_step(params, tokens, start, last_idx, cache,
                             chunk_ids, block_tbl, *, adapter_idx=None):
        logits, cache = tf.forward(
            params, cfg, tokens, cache=cache, adapter_idx=adapter_idx,
            start_pos=start, last_pos=last_idx, block_tbl=block_tbl,
            chunk_ids=chunk_ids)
        return logits[:, -1], cache

    return chunked_prefill_step


def make_serve_step(cfg: ModelConfig):
    """ONE-token decode.  On a ring cache ``pos`` is the scalar position of
    every row; on the paged pools it is (B,) per-slot positions and
    ``block_tbl`` (B, MB) maps each slot's logical blocks to pool
    blocks."""

    def serve_step(params, token, cache, pos, *, adapter_idx=None,
                   block_tbl=None):
        return tf.decode_step(params, cfg, token, cache, pos,
                              adapter_idx=adapter_idx, block_tbl=block_tbl)

    return serve_step


def make_sampled_serve_step(cfg: ModelConfig):
    """``make_serve_step`` + the sampling epilogue: takes the per-row
    temperature/top_k/top_p/seed/counter vectors as data and returns the
    next tokens; ``temperature <= 0`` rows emit argmax of the raw
    logits."""
    serve = make_serve_step(cfg)

    def sampled_serve_step(params, token, cache, pos, *, temperature,
                           top_k, top_p, seed, counter, **kw):
        logits, cache = serve(params, token, cache, pos, **kw)
        nxt = sample_tokens(logits, temperature, top_k, top_p, seed,
                            counter)
        return nxt, cache

    return sampled_serve_step


class InferenceEngine:
    """Warm-function inference over a shared backbone, on ring caches.

    params: full tree whose LoRA leaves are stacked (N, ...) multi-adapter
    banks (``core.lora.stack_adapters``); requests carry adapter indices.
    Prefill attention runs the flash kernel, decode attention the
    ring-decode kernel, every LoRA site SGMV (on the card; the plain
    versions for ``device="cpu"``).
    """

    def __init__(self, cfg: ModelConfig, params: Params, *,
                 max_context: int = 2048, device="cuda"):
        self.cfg = cfg
        self.params = params
        self.max_context = max_context
        self.device = torch.device(device)
        self._prefill = make_prefill_step(cfg)
        self._decode = make_serve_step(cfg)

    def new_cache(self, batch: int,
                  context_len: Optional[int] = None) -> List[Dict[str, Any]]:
        return tf.init_cache(self.cfg, batch,
                             context_len or self.max_context,
                             device=self.device)

    def prefill(self, tokens: torch.Tensor,
                adapter_idx: Optional[torch.Tensor] = None,
                cache: Optional[List[Dict[str, Any]]] = None):
        """tokens: (B, T) int; adapter_idx: (B,) int32 or None.  A given
        cache must be fresh (``idx`` 0), else ValueError."""
        if cache is None:
            cache = self.new_cache(tokens.shape[0])
        return self._prefill(self.params, tokens, cache,
                             adapter_idx=adapter_idx)

    def generate(self, tokens: torch.Tensor, max_new_tokens: int,
                 adapter_idx: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
        """Greedy generation.  Returns ((B, max_new_tokens) int32, cache).

        The reference's ``lax.scan`` becomes a loop of ``max_new_tokens -
        1`` decode steps; each feeds back the argmax on the device, and the
        position stays a host int, so the loop never waits on the card."""
        T = tokens.shape[1]
        logits, cache = self.prefill(tokens, adapter_idx)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out = [tok]
        for i in range(max_new_tokens - 1):
            logits, cache = self._decode(self.params, tok, cache, T + i,
                                         adapter_idx=adapter_idx)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            out.append(tok)
        return torch.stack(out, dim=1), cache

    def decode_one(self, token: torch.Tensor, cache: List[Dict[str, Any]],
                   pos, adapter_idx: Optional[torch.Tensor] = None):
        return self._decode(self.params, token, cache, pos,
                            adapter_idx=adapter_idx)
