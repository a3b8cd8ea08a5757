"""Causal LM for attention-only stacks on the paged serving path (port of
the serving subset of ``repro/models/transformer.py``).

A plain loop over layers replaces the reference's period ``lax.scan``;
parameters are a dict with one entry per layer in ``params["layers"]``
(the weight bridge, ``checkpoint/bridge.py``, unstacks the reference's
period-stacked layout into it).

Entry points:
  * ``forward``     — one chunk of paged prefill: tokens at ``start_pos +
                      [0, T)``, logits at the per-row ``last_pos``.
  * ``decode_step`` — ONE token per row against the paged pools.
  * ``init_params`` — seeded random weights (for runs without a
                      checkpoint, e.g. the full-width run on the card).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.models.config import ATTN, SWIGLU, ModelConfig
from repro_torch.models.layers import apply_attention, apply_mlp, apply_norm

Params = Dict[str, Any]


# ----------------------------------------------------------------------- init
def _normal(gen: torch.Generator, shape, dtype, scale: float,
            device) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (t * scale).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda", *, lora_adapters: int = 1,
                lora_b_scale: float = 0.02) -> Params:
    """Seeded random parameters with the reference's init scales (dense
    N(0, 1/d_in), embeddings and LM head N(0, 0.02), norms at 1, LoRA A
    N(0, 1/d_in)) and a stacked bank of ``lora_adapters`` adapters on the
    config's targets.  Unlike the reference, whose LoRA B starts at zero,
    B is drawn N(0, ``lora_b_scale``) so every adapter's delta is real.
    ``generator`` must live on ``device``."""
    if any(kind != ATTN for kind in cfg.layer_kinds) or \
            cfg.mlp_for != SWIGLU:
        raise ValueError(f"{cfg.name}: only attention + SwiGLU stacks are "
                         f"ported")
    dt = cfg.torch_dtype
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, K, hd, r = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, \
        cfg.lora.rank
    N = lora_adapters

    def w(d_in, d_out):
        return {"w": _normal(generator, (d_in, d_out), dt,
                             1.0 / math.sqrt(d_in), device)}

    def ones(d):
        return {"scale": torch.ones((d,), dtype=dt, device=device)}

    shapes = {"q": (D, H * hd), "k": (D, K * hd), "v": (D, K * hd),
              "o": (H * hd, D)}
    layers: List[Params] = []
    for _ in range(cfg.num_layers):
        attn = {"wq": w(D, H * hd), "wk": w(D, K * hd), "wv": w(D, K * hd),
                "wo": w(H * hd, D)}
        if cfg.lora:
            attn["lora"] = {
                t: {"a": _normal(generator, (N, shapes[t][0], r), dt,
                                 1.0 / math.sqrt(shapes[t][0]), device),
                    "b": _normal(generator, (N, r, shapes[t][1]), dt,
                                 lora_b_scale, device)}
                for t in cfg.lora.targets if t in shapes}
        layers.append({"norm1": ones(D), "attn": attn, "norm2": ones(D),
                       "mlp": {"wi": w(D, F), "wg": w(D, F), "wo": w(F, D)}})
    p: Params = {
        "embed": _normal(generator, (V, D), dt, 0.02, device),
        "layers": layers,
        "final_norm": ones(D),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(generator, (D, V), dt, 0.02, device)
    return p


# -------------------------------------------------------------------- forward
def _embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather.  The reference's ``jnp.take`` returns NaN rows for
    an out-of-range id instead of failing; the runtime feeds only in-range
    ids (padding rows use id 0), and on the CPU this is checked."""
    V = params["embed"].shape[0]
    if tokens.device.type == "cpu" and tokens.numel() and (
            int(tokens.min()) < 0 or int(tokens.max()) >= V):
        raise ValueError(f"token ids outside [0, {V})")
    return params["embed"][tokens.long()]


def _run_stack(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
               positions: torch.Tensor, cache: List[Dict[str, torch.Tensor]],
               adapter_idx: Optional[torch.Tensor], block_tbl: torch.Tensor,
               chunk_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Residual blocks in stack order; the pools update in place."""
    T = x.shape[1]
    if adapter_idx is not None and T > 1:
        # per-token adapter ids, once per dispatch for all 4 x layers sites
        adapter_idx = adapter_idx.repeat_interleave(T)
    for lp, layer_cache in zip(params["layers"], cache):
        h = apply_norm(x, lp["norm1"], cfg.norm_type)
        x = x + apply_attention(
            lp["attn"], cfg, h, positions=positions, cache=layer_cache,
            block_tbl=block_tbl, adapter_idx=adapter_idx,
            chunk_ids=chunk_ids, window=cfg.sliding_window)
        h2 = apply_norm(x, lp["norm2"], cfg.norm_type)
        x = x + apply_mlp(lp["mlp"], cfg, h2)
    return x


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    if cfg.tie_embeddings:
        return x @ params["embed"].T
    return x @ params["lm_head"]


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: List[Dict[str, torch.Tensor]], start_pos: torch.Tensor,
            last_pos: torch.Tensor, block_tbl: torch.Tensor,
            chunk_ids: torch.Tensor,
            adapter_idx: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """One chunk of paged prefill.

    tokens: (B, T) int at positions ``start_pos[b] + [0, T)``; chunk_ids:
    (B, T//bs) pool blocks this chunk writes; block_tbl: (B, MB) the rows'
    full logical history; last_pos: (B,) in-chunk index whose logit to
    return.  Returns ((B, 1, V) logits, cache updated in place)."""
    B, T = tokens.shape
    x = _embed(params, tokens)
    positions = (start_pos[:, None]
                 + torch.arange(T, device=tokens.device)[None, :]
                 ).to(torch.int32)
    x = _run_stack(params, cfg, x, positions=positions, cache=cache,
                   adapter_idx=adapter_idx, block_tbl=block_tbl,
                   chunk_ids=chunk_ids)
    idx = last_pos.long()[:, None, None].expand(B, 1, x.shape[-1])
    return _logits(params, cfg, torch.gather(x, 1, idx)), cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: List[Dict[str, torch.Tensor]], pos: torch.Tensor, *,
                block_tbl: torch.Tensor,
                adapter_idx: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]]]:
    """ONE decode step.  token: (B,) int; pos: (B,) int32 per-row
    positions; block_tbl: (B, MB) int32.  Returns ((B, V) logits, cache
    updated in place)."""
    x = _embed(params, token[:, None])                     # (B, 1, D)
    positions = pos[:, None].to(torch.int32)
    x = _run_stack(params, cfg, x, positions=positions, cache=cache,
                   adapter_idx=adapter_idx, block_tbl=block_tbl)
    return _logits(params, cfg, x)[:, 0], cache
