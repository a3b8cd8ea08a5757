"""Serving steps over the paged multi-LoRA model (port of the serving
subset of ``repro/core/engine.py``).

The reference builds pure functions that the runtime jits; PyTorch runs
eagerly, so the factories here return plain functions that update the
paged pools in place (the stand-in for the reference's donated cache).
"""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.core.sampling import sample_tokens
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]


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
    """ONE-token decode: ``pos`` (B,) per-slot positions and ``block_tbl``
    (B, MB) map each slot's logical blocks to pool blocks."""

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
