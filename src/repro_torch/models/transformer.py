"""Causal LM (port of ``repro/models/transformer.py``) for stacks of
attention, RG-LRU (REC) and Mamba-2 (SSD) layers with a SwiGLU,
squared-ReLU, GELU or MoE MLP (none after SSD) and RMSNorm or LayerNorm,
over ring caches with REC/SSD ring state (the warm-function engine) or
paged pools with per-slot REC/SSD state rows (the serving runtime).  A
VLM's image prefix (``forward(embeds=)``) attends bidirectionally under
the prefix-LM mask on the ring path.  An encoder-decoder (Whisper) runs
its bidirectional encoder over stub frame embeddings
(``forward(frame_embeds=)``, ``encode``) and cross-attends to it in every
decoder layer, on the ring path only.

A plain loop over layers replaces the reference's period ``lax.scan``;
parameters are a dict with one entry per layer in ``params["layers"]``
(the weight bridge, ``checkpoint/bridge.py``, unstacks the reference's
period-stacked layout into it).  The cache's kind picks the branch, as in
the reference: every layer of a ring cache carries the token counter
``"idx"``; an attention layer of the paged cache holds ``"kp"`` pools.

Entry points:
  * ``forward``     — ring: prefill of a fresh cache at positions
                      ``[0, T)`` (``[0, P + T)`` behind P prefix
                      embeddings); paged: one chunk of prefill at
                      ``start_pos + [0, T)``, logits at ``last_pos``.
  * ``decode_step`` — ONE token per row: a scalar position on a ring
                      cache, per-row positions on the paged pools.
  * ``encode``      — the encoder stack over frame embeddings.
  * ``forward_train`` — the cache-free training forward (logits of every
                      token position and the MoE aux loss), which calls
                      no kernel.
  * ``init_params`` — seeded random weights (for runs without a
                      checkpoint, e.g. the full-width run on the card).
  * ``init_cache``  — ring caches (``models/cache.py``).
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from repro_torch.models import cache as cache_lib
from repro_torch.models.config import (ATTN, GELU, MOE, NONE, REC, SQRELU,
                                       SSD, SWIGLU, ModelConfig)
from repro_torch.models.layers import (_normal, apply_attention,
                                       apply_attention_train,
                                       apply_cross_attention,
                                       apply_encoder_attention,
                                       apply_encoder_mlp, apply_mlp,
                                       apply_norm, cross_attention_train,
                                       matmul)
from repro_torch.models.moe import apply_moe, moe_init
from repro_torch.models.rglru import apply_rglru_block, rglru_init
from repro_torch.models.ssm import apply_ssd, ssd_init

Params = Dict[str, Any]

# Optional activation-sharding hook (set by a launcher): pins the residual
# stream to a spec right after the embedding gather (and the image prefix's
# concatenation), as the reference's ``with_sharding_constraint`` does.
# Unset, it does nothing; set, a DTensor activation is redistributed to it
# (a plain tensor is not sharded and passes unchanged).
_ACT_SPEC = None


def set_activation_spec(spec, mesh=None) -> None:
    """``spec``: a ``launch.sharding`` spec for the (B, T, D) residual
    stream on ``mesh``, or None to unset."""
    global _ACT_SPEC
    _ACT_SPEC = None if spec is None else (tuple(spec), mesh)


def _constrain(x: torch.Tensor) -> torch.Tensor:
    if _ACT_SPEC is None or not isinstance(x, DTensor):
        return x
    from repro_torch.launch.sharding import to_placements
    spec, mesh = _ACT_SPEC
    mesh = mesh if mesh is not None else x.device_mesh
    return x.redistribute(mesh, to_placements(spec, mesh))


# ----------------------------------------------------------------------- init
def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device="cuda", *, lora_adapters: Optional[int] = 1,
                lora_b_scale: float = 0.02) -> Params:
    """Seeded random parameters with the reference's init scales (dense
    N(0, 1/d_in), embeddings and LM head N(0, 0.02), norm scales at 1,
    LoRA A N(0, 1/d_in); MoE router and ``wi``/``wg`` N(0, 1/D), ``wo``
    N(0, 1/F); REC and SSD blocks as ``rglru_init`` / ``ssd_init``) and a
    stacked bank of ``lora_adapters`` adapters ((N, D, r) / (N, r, O)
    leaves) on the config's targets: q/k/v/o of attention, in/out of the
    REC and SSD blocks; ``lora_adapters=None`` gives one adapter with
    (D, r) / (r, O) leaves, the training layout (the reference's
    ``init_params(lora_adapters=None)``).  An
    encoder-decoder also gets its encoder (``encoder_layers`` of
    attention with K = H and a GELU MLP, then a norm) and, in each
    decoder layer, ``normx`` and the cross-attention ``xattn``; neither
    carries LoRA, as in the reference.  Unlike the
    reference, whose LoRA B, QKV biases (``qkv_bias``) and LayerNorm
    biases start at zero, B is drawn N(0, ``lora_b_scale``) and the biases
    N(0, 0.02), so every adapter's delta and every bias is real.
    ``generator`` must live on ``device``.  On ``device="meta"`` the
    leaves have their names, shapes and dtypes and no storage, and nothing
    is drawn (``generator`` may be None): the dry run's abstract
    params."""
    if cfg.mlp_for not in (SWIGLU, SQRELU, GELU, MOE, NONE):
        raise ValueError(f"{cfg.name}: mlp {cfg.mlp_for!r} is not ported")
    dt = cfg.torch_dtype
    D, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, K, hd, r = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, \
        cfg.lora.rank
    N = lora_adapters

    def w(d_in, d_out, bias=False):
        p = {"w": _normal(generator, (d_in, d_out), dt,
                          1.0 / math.sqrt(d_in), device)}
        if bias:
            p["b"] = _normal(generator, (d_out,), dt, 0.02, device)
        return p

    def ones(d):
        p = {"scale": torch.ones((d,), dtype=dt, device=device)}
        if cfg.norm_type == "layernorm":
            p["bias"] = _normal(generator, (d,), dt, 0.02, device)
        return p

    lead = () if N is None else (N,)

    def bank(shapes):
        return {t: {"a": _normal(generator, lead + (shapes[t][0], r), dt,
                                 1.0 / math.sqrt(shapes[t][0]), device),
                    "b": _normal(generator, lead + (r, shapes[t][1]), dt,
                                 lora_b_scale, device)}
                for t in cfg.lora.targets if t in shapes}

    def attention(kv_heads):
        qb = cfg.qkv_bias
        return {"wq": w(D, H * hd, qb), "wk": w(D, kv_heads * hd, qb),
                "wv": w(D, kv_heads * hd, qb), "wo": w(H * hd, D)}

    attn_shapes = {"q": (D, H * hd), "k": (D, K * hd), "v": (D, K * hd),
                   "o": (H * hd, D)}
    fused = 2 * cfg.d_inner + 2 * cfg.ssm_state_dim + cfg.ssm_num_heads
    inout = {REC: {"in": (D, cfg.d_inner), "out": (cfg.d_inner, D)},
             SSD: {"in": (D, fused), "out": (cfg.d_inner, D)}}
    layers: List[Params] = []
    for kind in cfg.layer_kinds:
        layer: Params = {"norm1": ones(D)}
        if kind == ATTN:
            attn = attention(K)
            if cfg.lora:
                attn["lora"] = bank(attn_shapes)
            layer["attn"] = attn
            if cfg.cross_attention:
                layer["normx"] = ones(D)
                layer["xattn"] = attention(K)
        else:
            name, block = ("rec", rglru_init) if kind == REC else \
                ("ssd", ssd_init)
            layer[name] = block(generator, cfg, dt, device)
            lora = bank(inout[kind])
            if lora:
                layer[name]["lora"] = lora
        if cfg.mlp_for != NONE:
            layer["norm2"] = ones(D)
        if cfg.mlp_for == MOE:
            layer["moe"] = moe_init(generator, cfg, dt, device)
        elif cfg.mlp_for == SWIGLU:
            layer["mlp"] = {"wi": w(D, F), "wg": w(D, F), "wo": w(F, D)}
        elif cfg.mlp_for in (SQRELU, GELU):
            layer["mlp"] = {"wi": w(D, F), "wo": w(F, D)}
        layers.append(layer)
    p: Params = {
        "embed": _normal(generator, (V, D), dt, 0.02, device),
        "layers": layers,
        "final_norm": ones(D),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = _normal(generator, (D, V), dt, 0.02, device)
    if cfg.encoder_layers:
        p["encoder"] = {
            "layers": [{"norm1": ones(D), "attn": attention(H),
                        "norm2": ones(D),
                        "mlp": {"wi": w(D, F), "wo": w(F, D)}}
                       for _ in range(cfg.encoder_layers)],
            "norm": ones(D)}
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


def _state_mixer(apply, p: Params, cfg: ModelConfig, h: torch.Tensor,
                 layer_cache: Dict[str, torch.Tensor],
                 positions: torch.Tensor,
                 state_rows: Optional[torch.Tensor],
                 state_seq: Optional[torch.Tensor],
                 adapter_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """A REC/SSD block over its slot-state rows: gather each dispatch row's
    state (zeros for a row starting at position 0), run decode (T == 1) or
    chunked-prefill continuation (T > 1, ``state_seq`` valid-token counts
    masking the chunk tail), scatter the new state back in place."""
    if state_rows is None:
        raise ValueError("REC/SSD layers need state_rows (the paged "
                         "runtime's slot-state rows)")
    st = cache_lib.gather_slot_state(layer_cache, state_rows, positions)
    mix, upd = apply(p, cfg, h, state=st, seq_lens=state_seq,
                     lora=p.get("lora"), lora_scaling=cfg.lora.scaling,
                     adapter_idx=adapter_idx)
    cache_lib.scatter_slot_state(layer_cache, upd, state_rows)
    return mix


def _ring_state_mixer(apply, p: Params, cfg: ModelConfig, h: torch.Tensor,
                      layer_cache: Dict[str, Any],
                      adapter_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """A REC/SSD block over its ring state (the warm-function engine), as
    the reference's ``_apply_layer`` runs it on ``rec_cache`` /
    ``ssd_cache``: prefill (T > 1) of a fresh cache from the zero state,
    decode (T == 1) from the carried one.  The new state is copied into
    the cache's own tensors, so a captured decode step replays on the same
    addresses."""
    T = h.shape[1]
    if T > 1 and layer_cache["idx"] != 0:
        raise ValueError(f"ring prefill needs a fresh cache (idx 0, got "
                         f"{layer_cache['idx']})")
    names = [k for k in layer_cache if k != "idx"]
    state = None if T > 1 else {k: layer_cache[k] for k in names}
    mix, upd = apply(p, cfg, h, state=state, lora=p.get("lora"),
                     lora_scaling=cfg.lora.scaling, adapter_idx=adapter_idx)
    for k in names:
        layer_cache[k].copy_(upd[k])
    layer_cache["idx"] += T
    return mix


def _run_stack(params: Params, cfg: ModelConfig, x: torch.Tensor, *,
               positions: torch.Tensor, cache: List[Dict[str, Any]],
               adapter_idx: Optional[torch.Tensor],
               block_tbl: Optional[torch.Tensor] = None,
               chunk_ids: Optional[torch.Tensor] = None,
               state_rows: Optional[torch.Tensor] = None,
               state_seq: Optional[torch.Tensor] = None,
               prefix_len: int = 0,
               enc_out: Optional[torch.Tensor] = None,
               decoding: bool = False) -> torch.Tensor:
    """Residual blocks in stack order; the caches update in place.  A
    REC/SSD layer runs over slot-state rows when ``state_rows`` is given
    (the paged runtime), else over its ring state.  On a cross-attention
    model each ATTN layer then cross-attends on ``normx(x)``: at prefill
    over ``enc_out`` (its K/V written into the layer's cross cache), at
    decode (``decoding``) over the cached K/V; a prefill without frames
    skips it and leaves the cross cache as it was, as the reference
    does."""
    B, T = x.shape[:2]
    if adapter_idx is not None and T > 1:
        # per-token adapter ids, once per dispatch for every LoRA site
        # (an expand: repeat_interleave may read its size back to the host)
        adapter_idx = adapter_idx[:, None].expand(B, T).contiguous().view(
            B * T)
    for kind, lp, layer_cache in zip(cfg.layer_kinds, params["layers"],
                                     cache):
        h = apply_norm(x, lp["norm1"], cfg.norm_type)
        if kind == ATTN:
            x = x + apply_attention(
                lp["attn"], cfg, h, positions=positions, cache=layer_cache,
                block_tbl=block_tbl, adapter_idx=adapter_idx,
                chunk_ids=chunk_ids, window=cfg.sliding_window,
                prefix_len=prefix_len)
            if cfg.cross_attention and (enc_out is not None or decoding):
                hx = apply_norm(x, lp["normx"], cfg.norm_type)
                x = x + apply_cross_attention(lp["xattn"], cfg, hx,
                                              layer_cache, enc_out)
        else:
            apply, name = (apply_rglru_block, "rec") if kind == REC else \
                (apply_ssd, "ssd")
            if state_rows is None and "idx" in layer_cache:
                mix = _ring_state_mixer(apply, lp[name], cfg, h,
                                        layer_cache, adapter_idx)
            else:
                mix = _state_mixer(apply, lp[name], cfg, h, layer_cache,
                                   positions, state_rows, state_seq,
                                   adapter_idx)
            x = x + mix
        if cfg.mlp_for == NONE:
            continue
        h2 = apply_norm(x, lp["norm2"], cfg.norm_type)
        if cfg.mlp_for == MOE:
            x = x + apply_moe(lp["moe"], cfg, h2)
        else:
            x = x + apply_mlp(lp["mlp"], cfg, h2)
    return x


def _logits(params: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(x, params["final_norm"], cfg.norm_type)
    if cfg.tie_embeddings:
        return matmul(x, params["embed"].T)
    return matmul(x, params["lm_head"])


def _is_ring(cache: List[Dict[str, Any]]) -> bool:
    """Every layer of a ring cache carries the host token counter."""
    return "idx" in cache[0]


def encode(params: Params, cfg: ModelConfig,
           frame_embeds: torch.Tensor) -> torch.Tensor:
    """The bidirectional encoder over precomputed frame embeddings (B, T,
    D) (the reference's stub frontend: the mel/conv features run
    upstream), cast to the model dtype: per layer a pre-norm attention
    with RoPE at ``[0, T)`` and a pre-norm GELU MLP, then a final norm.
    Returns (B, T, D)."""
    enc = params["encoder"]
    x = frame_embeds.to(cfg.torch_dtype)
    for lp in enc["layers"]:
        h = apply_norm(x, lp["norm1"], cfg.norm_type)
        x = x + apply_encoder_attention(lp["attn"], cfg, h)
        h2 = apply_norm(x, lp["norm2"], cfg.norm_type)
        x = x + apply_encoder_mlp(lp["mlp"], h2)
    return apply_norm(x, enc["norm"], cfg.norm_type)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
            cache: List[Dict[str, Any]],
            embeds: Optional[torch.Tensor] = None,
            frame_embeds: Optional[torch.Tensor] = None,
            adapter_idx: Optional[torch.Tensor] = None,
            last_only: bool = False,
            start_pos: Optional[torch.Tensor] = None,
            last_pos: Optional[torch.Tensor] = None,
            block_tbl: Optional[torch.Tensor] = None,
            chunk_ids: Optional[torch.Tensor] = None,
            state_rows: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """Prefill; the cache updates in place.

    Ring cache: tokens (B, T) at positions [0, T) fill a FRESH cache
    (``idx`` 0; anything else raises ValueError — the reference would let
    the new queries attend to older slots).  A prompt longer than the ring
    keeps its last S keys.  ``embeds`` (B, P, D): a VLM's image-patch
    embeddings (the reference's stub frontend) placed before the tokens at
    positions [0, P), the tokens then at [P, P + T), under the prefix-LM
    mask: the P prefix keys are visible to every query.  REC/SSD layers
    start from the zero state.  ``frame_embeds`` (B, encoder_seq, D): an
    encoder-decoder's audio frames (the stub frontend's output), encoded
    once; each decoder layer's cross cache takes their K/V in place.
    Frames of another length raise ValueError: the cross cache is
    preallocated at ``encoder_seq`` for a captured decode step's fixed
    addresses (the reference rebinds it to any length).

    Paged pools: one chunk at positions ``start_pos[b] + [0, T)``;
    chunk_ids: (B, T//bs) pool blocks this chunk writes; block_tbl: (B, MB)
    the rows' full logical history.  ``state_rows`` (B,) maps each row to
    its REC/SSD slot-state row: a chunk continues the recurrent scans from
    the carried state, and ``last_pos`` doubles as the in-chunk bound of
    valid tokens, so chunk-tail padding never advances the state.

    Logits: at the per-row index ``last_pos`` (B,) if given (counted from
    the first prefix position, as the reference does), else at the last
    position with ``last_only``, else at each of the T token positions.
    Returns (logits (B, 1 or T, V), cache)."""
    B, T = tokens.shape
    x = _constrain(_embed(params, tokens))
    prefix_len = 0
    if embeds is not None:
        if not _is_ring(cache):
            raise ValueError("an image prefix (embeds) is served on ring "
                             "caches only: the paged runtime carries none")
        x = _constrain(torch.cat([embeds.to(x.dtype), x], dim=1))
        prefix_len = embeds.shape[1]
    enc_out = None
    if frame_embeds is not None:
        if not _is_ring(cache):
            raise ValueError("audio frames (frame_embeds) are served on ring "
                             "caches only: the paged runtime carries none")
        if not cfg.cross_attention:
            raise ValueError(f"{cfg.name} has no cross-attention to take "
                             f"frame_embeds")
        if frame_embeds.shape[1] != cfg.encoder_seq:
            raise ValueError(f"{frame_embeds.shape[1]} frames for a cross "
                             f"cache of encoder_seq {cfg.encoder_seq}")
        enc_out = encode(params, cfg, frame_embeds)
    Ttot = x.shape[1]
    offs = torch.arange(Ttot, device=tokens.device)[None, :]
    if _is_ring(cache):
        positions = offs.expand(B, Ttot).to(torch.int32)
    else:
        positions = (start_pos[:, None] + offs).to(torch.int32)
    state_seq = None
    if state_rows is not None and last_pos is not None:
        state_seq = last_pos.to(torch.int32) + 1
    x = _run_stack(params, cfg, x, positions=positions, cache=cache,
                   adapter_idx=adapter_idx, block_tbl=block_tbl,
                   chunk_ids=chunk_ids, state_rows=state_rows,
                   state_seq=state_seq, prefix_len=prefix_len,
                   enc_out=enc_out)
    if last_pos is not None:
        idx = last_pos.long()[:, None, None].expand(B, 1, x.shape[-1])
        return _logits(params, cfg, torch.gather(x, 1, idx)), cache
    if last_only:
        return _logits(params, cfg, x[:, -1:]), cache
    return _logits(params, cfg, x[:, prefix_len:]), cache


def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: List[Dict[str, Any]],
                pos: Union[int, torch.Tensor], *,
                block_tbl: Optional[torch.Tensor] = None,
                adapter_idx: Optional[torch.Tensor] = None,
                state_rows: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[Dict[str, Any]]]:
    """ONE decode step.  token: (B,) int.  On a ring cache ``pos`` is the
    scalar absolute position of every row (an int, or a 0-d tensor),
    broadcast to (B, 1), and must equal the ring's ``idx`` (the tokens it
    has seen): the token is written at slot ``pos % S``, computed on the
    device so that a captured step can replay at any position.  On the
    paged pools it is (B,) int32 per-row positions and block_tbl (B, MB)
    int32; ``state_rows`` (B,) int32 addresses the REC/SSD slot-state rows
    (a row pointed at the garbage row computes on junk and writes it
    there, leaving real state untouched).  A cross-attention model's
    layers attend over their cached encoder K/V too.  Returns ((B, V)
    logits, cache updated in place)."""
    B = token.shape[0]
    if _is_ring(cache) and (not isinstance(pos, torch.Tensor)
                            or pos.device.type == "cpu"):
        if int(pos) != cache[0]["idx"]:
            raise ValueError(f"ring decode at position {int(pos)} of a ring "
                             f"that has seen {cache[0]['idx']} tokens")
    x = _constrain(_embed(params, token[:, None]))         # (B, 1, D)
    if not isinstance(pos, torch.Tensor):
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=token.device)
    elif pos.dim() == 1:
        positions = pos[:, None].to(torch.int32)
    else:
        positions = pos.reshape(1, 1).expand(B, 1).to(torch.int32)
    x = _run_stack(params, cfg, x, positions=positions, cache=cache,
                   adapter_idx=adapter_idx, block_tbl=block_tbl,
                   state_rows=state_rows, decoding=True)
    return _logits(params, cfg, x)[:, 0], cache


# --------------------------------------------------------- training forward
def _train_layer(kind: str, lp: Params, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, mask_kind: str, prefix_len: int,
                 use_chunked: bool, enc_out: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One residual block without a cache (the reference's ``_apply_layer``
    with ``cache=None``): REC/SSD mixers from the zero state, a MoE MLP's
    load-balance loss returned beside x.  Returns (x, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = apply_norm(x, lp["norm1"], cfg.norm_type)
    if kind == ATTN:
        x = x + apply_attention_train(
            lp["attn"], cfg, h, positions=positions, mask_kind=mask_kind,
            prefix_len=prefix_len, window=cfg.sliding_window,
            use_chunked=use_chunked)
        if cfg.cross_attention and enc_out is not None:
            hx = apply_norm(x, lp["normx"], cfg.norm_type)
            x = x + cross_attention_train(lp["xattn"], cfg, hx, enc_out)
    else:
        apply, name = (apply_rglru_block, "rec") if kind == REC else \
            (apply_ssd, "ssd")
        mix, _ = apply(lp[name], cfg, h, lora=lp[name].get("lora"),
                       lora_scaling=cfg.lora.scaling)
        x = x + mix
    if cfg.mlp_for == MOE:
        h2 = apply_norm(x, lp["norm2"], cfg.norm_type)
        out, moe_aux = apply_moe(lp["moe"], cfg, h2, return_aux=True)
        aux = aux + moe_aux["load_balance_loss"]
        x = x + out
    elif cfg.mlp_for != NONE:
        h2 = apply_norm(x, lp["norm2"], cfg.norm_type)
        x = x + apply_mlp(lp["mlp"], cfg, h2)
    return x, aux


def _encode_train(params: Params, cfg: ModelConfig,
                  frame_embeds: torch.Tensor) -> torch.Tensor:
    """``encode`` through ``attention_core`` (the reference's encoder:
    bidirectional attention with K = H and RoPE at ``[0, T)``, a GELU
    MLP, a final norm) instead of the flash kernel."""
    enc = params["encoder"]
    enc_cfg = cfg.with_(num_kv_heads=cfg.num_heads)
    x = frame_embeds.to(cfg.torch_dtype)
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    for lp in enc["layers"]:
        h = apply_norm(x, lp["norm1"], cfg.norm_type)
        x = x + apply_attention_train(lp["attn"], enc_cfg, h,
                                      positions=positions, mask_kind="bidir")
        h2 = apply_norm(x, lp["norm2"], cfg.norm_type)
        x = x + apply_encoder_mlp(lp["mlp"], h2)
    return apply_norm(x, enc["norm"], cfg.norm_type)


def forward_train(params: Params, cfg: ModelConfig, tokens: torch.Tensor, *,
                  embeds: Optional[torch.Tensor] = None,
                  frame_embeds: Optional[torch.Tensor] = None,
                  remat: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: the reference's ``forward(cache=None)``.

    tokens (B, T) at positions ``[0, T)``, or ``[P, P + T)`` behind P
    prefix ``embeds`` (B, P, D) under the prefix-LM mask; the config's
    window applies.  Attention runs through ``attention_core``, or
    ``attention_chunked`` past 2048 positions; a single adapter's LoRA
    (leaves (D, r) / (r, O)) is the plain ``(x @ A) @ B``; REC/SSD layers
    start from the zero state.  An encoder-decoder encodes
    ``frame_embeds`` (B, S, D) and cross-attends to it in every decoder
    layer.  No kernel is called: their outputs carry no gradient.
    ``remat`` recomputes each layer in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations.
    Returns (logits (B, T, V) of the T token positions, aux: the sum of
    the MoE layers' load-balance losses, float32)."""
    T = tokens.shape[1]
    x = _constrain(_embed(params, tokens))
    prefix_len = 0
    if embeds is not None:
        x = _constrain(torch.cat([embeds.to(x.dtype), x], dim=1))
        prefix_len = embeds.shape[1]
    B, Ttot = x.shape[:2]
    positions = torch.arange(Ttot, device=x.device)[None].expand(B, Ttot)
    enc_out = None
    if cfg.encoder_layers and frame_embeds is not None:
        enc_out = _encode_train(params, cfg, frame_embeds)
    mask_kind = "prefix" if prefix_len else "causal"
    use_chunked = Ttot > 2048
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp in zip(cfg.layer_kinds, params["layers"]):
        layer = functools.partial(_train_layer, kind, lp, cfg,
                                  positions=positions, mask_kind=mask_kind,
                                  prefix_len=prefix_len,
                                  use_chunked=use_chunked, enc_out=enc_out)
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                layer, x, use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = layer(x)
        aux = aux + a
    return _logits(params, cfg, x[:, -T:]), aux


init_cache = cache_lib.init_cache
