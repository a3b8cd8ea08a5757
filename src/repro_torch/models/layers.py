"""Core layers (port of ``repro/models/layers.py``): dense (+ bias) +
LoRA delta, RMSNorm and LayerNorm, RoPE, the SwiGLU, squared-ReLU and
GELU MLPs (and the encoder's GELU MLP), the ring and paged branches of
attention (the ring branch with the prefix-LM rule of a VLM's image
prefix), the encoder's bidirectional attention and the decoder's
cross-attention over the encoder's output, the cache-free attention of
the training forward (``attention_core`` / ``attention_chunked`` in plain
float32 PyTorch, as the reference's model code computes it: the kernels
have no backward), and the depthwise causal conv of the REC and SSD
mixers.

Parameters are plain dicts of tensors in the reference's layout
(``x @ W`` with W of shape (d_in, d_out)), so weights carry over from the
JAX package unchanged.  LoRA is unmerged: the backbone product and the
per-row adapter delta (SGMV) are computed separately and summed — the
paper's backbone-sharing requirement.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.decode_attention.ops import decode_gqa
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.paged_attention.ops import paged_decode_gqa
from repro_torch.kernels.paged_prefill.ops import paged_prefill_gqa
from repro_torch.kernels.sgmv.ops import sgmv_tokens
from repro_torch.models.config import GELU, SQRELU, SWIGLU, ModelConfig

Params = Dict[str, Any]


def _normal(gen: torch.Generator, shape, dtype, scale: float,
            device) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 from ``gen``, cast to ``dtype``
    (scaled in place: one float32 copy of the leaf at a time)."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return t.mul_(scale).to(dtype)


# ------------------------------------------------------------------- dense/LoRA
def lora_delta(x: torch.Tensor, lora: Params, adapter_idx: torch.Tensor, *,
               scaling: float = 1.0) -> torch.Tensor:
    """Per-row multi-LoRA delta  scaling * (x @ A[idx]) @ B[idx].

    x: (B, T, D); adapter_idx: (B,) or per token (B * T,) int32; lora
    holds stacked banks
    {"a": (N, D, r), "b": (N, r, O)}.  Every LoRA site of both serving
    dispatches goes through SGMV here.  Rows whose id falls outside the
    bank get a zero delta."""
    return sgmv_tokens(x, lora["a"], lora["b"], adapter_idx, scaling=scaling)


def dense(x: torch.Tensor, p: Params, lora: Optional[Params] = None, *,
          scaling: float = 1.0,
          adapter_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W (+ b) (+ LoRA delta) — unmerged LoRA.

    ``lora`` holds {"a": (D, r), "b": (r, O)} for a single adapter
    (``adapter_idx`` None: y + scaling * ((x @ A) @ B)), or a stacked bank
    {"a": (N, D, r), "b": (N, r, O)} with per-row ``adapter_idx`` (the SGMV
    delta, cast to y's dtype)."""
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    if lora is not None:
        if adapter_idx is None:
            if lora["a"].dim() != 2:
                raise ValueError("a LoRA bank needs per-row adapter_idx")
            y = y + scaling * ((x @ lora["a"]) @ lora["b"])
        else:
            y = y + lora_delta(x, lora, adapter_idx,
                               scaling=scaling).to(y.dtype)
    return y


# ---------------------------------------------------------------- causal conv
def causal_conv1d(xs: torch.Tensor, w: torch.Tensor,
                  state: Optional[torch.Tensor] = None,
                  seq_lens: Optional[torch.Tensor] = None):
    """Depthwise causal conv shared by the REC and SSD mixers.

    xs: (B, T, Di); w: (W, Di); state: (B, W-1, Di) carried inputs
    (decode / chunked-prefill continuation).  ``seq_lens``: (B,) valid-
    token counts — the returned tail then holds the W-1 inputs ENDING at
    each row's last valid token (chunk-tail padding never leaks into the
    carried state); None keeps the plain last-W-1 tail.  The taps are
    summed in the reference's order, each product and sum in xs's dtype.
    Returns (out (B, T, Di), new_state (B, W-1, Di))."""
    W = w.shape[0]
    B, T = xs.shape[:2]
    if state is None:
        pad = xs.new_zeros((B, W - 1) + tuple(xs.shape[2:]))
    else:
        pad = state.to(xs.dtype)
    xfull = torch.cat([pad, xs], dim=1)                  # (B, T+W-1, Di)
    out = xfull[:, 0:T] * w[0]
    for i in range(1, W):
        out = out + xfull[:, i:i + T] * w[i]
    if seq_lens is None:
        return out, xfull[:, T:]
    # input of in-chunk token i sits at xfull index (W-1)+i; the tail ends
    # at the last valid token, i.e. xfull[len : len + W - 1]
    idx = seq_lens.long()[:, None] + torch.arange(W - 1,
                                                  device=xs.device)[None]
    idx = idx[..., None].expand(B, W - 1, xfull.shape[-1])
    return out, torch.gather(xfull, 1, idx)


# ----------------------------------------------------------------------- norms
def apply_norm(x: torch.Tensor, p: Params, kind: str,
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm, or LayerNorm (``p["bias"]`` beside ``p["scale"]``; mean
    removed, biased variance), each step in float32 as the reference
    computes it and cast once back to x's dtype."""
    if kind not in ("rmsnorm", "layernorm"):
        raise ValueError(f"norm {kind!r}")
    xf = x.float()
    if kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        d = xf - mu
        var = torch.mean(d * d, dim=-1, keepdim=True)
        y = d * torch.rsqrt(var + eps)
        return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


# ------------------------------------------------------------------------ RoPE
def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T).  Computed in float32, cast once
    to x's dtype."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(0, half, dtype=torch.float32,
                                     device=x.device) / half)
    ang = positions[..., None].float() * freqs              # (B, T, half)
    cos = torch.cos(ang)[..., None, :]                      # over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------- attention
def _write_decode_kv(pool: torch.Tensor, new: torch.Tensor,
                     block_tbl: torch.Tensor, pos: torch.Tensor) -> None:
    """Write one token per row at block_tbl[b, pos // bs], offset pos % bs,
    in place.  A -1 entry (inactive/stalled row) and a block index past the
    table's width both land in the garbage block 0 — the reference gets the
    latter from ``take_along_axis``'s out-of-range fill (INT32_MIN, then
    ``max(., 0)``), which the runtime relies on for stalled slots."""
    bs = pool.shape[2]
    MB = block_tbl.shape[1]
    j = torch.div(pos, bs, rounding_mode="floor").long()
    inside = j < MB
    blk = torch.gather(block_tbl, 1, j.clamp(max=MB - 1)[:, None])[:, 0]
    blk = torch.where(inside, blk, torch.full_like(blk, -1)).clamp(min=0)
    off = torch.remainder(pos, bs).long()
    pool[:, blk.long(), off] = new.to(pool.dtype).transpose(0, 1)


def _ring_attention(cache: Dict[str, Any], q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, positions: torch.Tensor,
                    window: Optional[int],
                    prefix_len: int = 0) -> torch.Tensor:
    """Ring-cache write, then attention (the warm-function engine).

    T > 1 is prefill into a fresh cache (``idx == 0``): the T new K/V go to
    slots [0, T) with ``slot_pos`` = their positions, and since every other
    slot is empty (-1) the reference's masked attention over the whole
    ring is causal attention over the T new keys: the flash kernel.  A
    prompt longer than the ring (T > S) attends over all T keys and keeps
    the last S (the reference's ring overflow, transformer.py:193-224).
    ``prefix_len`` > 0 is the reference's prefix-LM mask (``_scores_mask``
    kind "prefix"): prefill keys below it are visible to every query, as
    a VLM's image prefix is; a decode query sits past them anyway.
    T == 1 is decode: write at slot ``idx % S`` — computed on the device
    as ``position % S``, since the decode position equals ``idx``
    (``transformer.decode_step``) — then attend over the ring by
    ``slot_pos`` with the ring-decode kernel.  ``idx`` advances by T."""
    B, T = q.shape[:2]
    S = cache["k"].shape[1]
    idx = cache["idx"]
    if T > 1 and idx != 0:
        raise ValueError(f"ring prefill needs a fresh cache (idx 0, got "
                         f"{idx}): queries at positions [0, T) would "
                         f"attend to older slots")
    if T > S:
        out = flash_mha(q, k, v, causal=True, window=window,
                        prefix_len=prefix_len)
        cache["k"].copy_(k[:, -S:])
        cache["v"].copy_(v[:, -S:])
        cache["slot_pos"].copy_(positions[0, -S:])
    elif T > 1:
        cache["k"][:, :T] = k.to(cache["k"].dtype)
        cache["v"][:, :T] = v.to(cache["v"].dtype)
        cache["slot_pos"][:T] = positions[0]
        out = flash_mha(q, k, v, causal=True, window=window,
                        prefix_len=prefix_len)
    else:
        slot = torch.remainder(positions[0], S).long()           # (1,)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        cache["slot_pos"].index_copy_(0, slot, positions[0])
        out = decode_gqa(q[:, 0], cache["k"], cache["v"],
                         cache["slot_pos"], positions[0, 0],
                         window=window)[:, None]
    cache["idx"] = idx + T
    return out


def apply_attention(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                    positions: torch.Tensor, cache: Dict[str, Any],
                    block_tbl: Optional[torch.Tensor] = None,
                    adapter_idx: Optional[torch.Tensor] = None,
                    chunk_ids: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """GQA attention over one layer's cache, updated IN PLACE.

    x: (B, T, D); positions: (B, T) absolute positions.  The cache's kind
    picks the branch, as in the reference:

    Ring cache {"k","v": (B, S, K, hd), "slot_pos", "idx"} (the engine):
    every row shares the positions of row 0 (``_ring_attention``, with
    the prefix-LM bound ``prefix_len`` at prefill).

    Paged pools {"kp","vp"}: (K, NB, bs, hd) (serving), with block_tbl:
    (B, MB) int32 logical -> physical block map (-1 = unallocated).
    T > 1 is chunked paged prefill: the chunk's K/V go straight into whole
    pool blocks (``chunk_ids`` (B, T//bs) physical ids; garbage-block
    entries are skipped writes), then the chunk's queries attend over the
    row's entire paged history through the table.  T == 1 is decode: each
    row writes its token at block_tbl[b, pos//bs] offset pos%bs, then
    attends over its own blocks.  Returns the (B, T, D) mixer output."""
    B, T, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    lora = p.get("lora", {})
    s = cfg.lora.scaling if cfg.lora else 1.0

    q = dense(x, p["wq"], lora.get("q"), scaling=s, adapter_idx=adapter_idx)
    k = dense(x, p["wk"], lora.get("k"), scaling=s, adapter_idx=adapter_idx)
    v = dense(x, p["wv"], lora.get("v"), scaling=s, adapter_idx=adapter_idx)
    q = rope(q.reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, T, K, hd), positions, cfg.rope_theta)
    v = v.reshape(B, T, K, hd)
    if "k" in cache:
        out = _ring_attention(cache, q, k, v, positions, window, prefix_len)
        return dense(out.reshape(B, T, H * hd), p["wo"], lora.get("o"),
                     scaling=s, adapter_idx=adapter_idx)
    kp, vp = cache["kp"], cache["vp"]
    bs = kp.shape[2]

    if T > 1:
        if chunk_ids is None or T % bs:
            raise ValueError("paged prefill needs chunk_ids and a chunk of "
                             "whole blocks")
        nb_c = T // bs
        # (B, T, K, hd) -> (K, B, nb_c, bs, hd); several rows may target the
        # garbage block at once, which is never read
        ids = chunk_ids.long()
        kp[:, ids] = k.reshape(B, nb_c, bs, K, hd).permute(
            3, 0, 1, 2, 4).to(kp.dtype)
        vp[:, ids] = v.reshape(B, nb_c, bs, K, hd).permute(
            3, 0, 1, 2, 4).to(vp.dtype)
        out = paged_prefill_gqa(q, kp, vp, block_tbl, positions,
                                window=window)
    else:
        pos = positions[:, -1]
        _write_decode_kv(kp, k[:, 0], block_tbl, pos)
        _write_decode_kv(vp, v[:, 0], block_tbl, pos)
        out = paged_decode_gqa(q[:, 0], kp, vp, block_tbl, pos,
                               window=window)
    return dense(out.reshape(B, T, H * hd), p["wo"], lora.get("o"),
                 scaling=s, adapter_idx=adapter_idx)


# ------------------------------------------------ cache-free attention (train)
def _scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, kind: str,
                 window: Optional[int], prefix_len: int = 0) -> torch.Tensor:
    """Additive float32 mask (..., Tq, Tk) from absolute positions: 0 where
    key j is visible to query i, -1e30 elsewhere.  ``kind`` is "causal",
    "prefix" (causal, and every key below ``prefix_len`` visible) or
    "bidir"; keys at negative positions (padding) are never visible."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    if kind == "bidir":
        ok = kp >= 0
    elif kind == "prefix":
        ok = (kp <= qp) | (kp < prefix_len)
    elif kind == "causal":
        ok = kp <= qp
    else:
        raise ValueError(f"mask kind {kind!r}")
    ok = ok & (kp >= 0)
    if window is not None:
        ok = ok & (kp > qp - window)
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, torch.full_like(zero, -1e30))


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Dense attention in float32 under an additive mask (B, Tq, Tk).
    q: (B, Tq, H, hd); k, v: (B, Tk, K, hd), H % K == 0.  Returns
    (B, Tq, H, hd) in q's dtype."""
    B, Tq, H, hd = q.shape
    K = k.shape[2]
    qh = q.reshape(B, Tq, K, H // K, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qh.float(),
                          k.float()) / math.sqrt(hd)
    scores = scores + mask[:, None, None, :, :]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Tq, H, hd).to(q.dtype)


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      kind: str = "causal", window: Optional[int] = None,
                      prefix_len: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over ``q_chunk`` x ``kv_chunk`` blocks in
    float32: ``attention_core``'s function with O(chunk^2) temporaries.
    Padded queries sit at position -1e9 and padded keys at -1, so the mask
    hides them.  q_pos, k_pos: (T,) or (B, T).  Returns (B, Tq, H, hd) in
    q's dtype."""
    B, Tq, H, hd = q.shape
    Tk, Kh = k.shape[1], k.shape[2]
    G = H // Kh
    q_chunk, kv_chunk = min(q_chunk, Tq), min(kv_chunk, Tk)
    nq, nk = -(-Tq // q_chunk), -(-Tk // kv_chunk)
    pad_q, pad_k = nq * q_chunk - Tq, nk * kv_chunk - Tk
    q_pos = q_pos.expand(B, Tq) if q_pos.dim() == 1 else q_pos
    k_pos = k_pos.expand(B, Tk) if k_pos.dim() == 1 else k_pos
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp_ = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp_ = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    qpos = F.pad(q_pos, (0, pad_q), value=-(10 ** 9))
    kpos = F.pad(k_pos, (0, pad_k), value=-1)
    sm = 1.0 / math.sqrt(hd)
    outs = []
    for i in range(nq):
        qs = slice(i * q_chunk, (i + 1) * q_chunk)
        qb = qp[:, qs].reshape(B, q_chunk, Kh, G, hd).float()
        acc = q.new_zeros((B, q_chunk, Kh, G, hd), dtype=torch.float32)
        m = torch.full((B, q_chunk, Kh, G), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for j in range(nk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            s = torch.einsum("bqkgh,bskh->bqkgs", qb,
                             kp_[:, ks].float()) * sm
            s = s + _scores_mask(qpos[:, qs], kpos[:, ks], kind, window,
                                 prefix_len)[:, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgs,bskh->bqkgh", p, vp_[:, ks].float())
            m = m_new
        outs.append((acc / l.clamp(min=1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=1).reshape(B, nq * q_chunk, H, hd)
    return out[:, :Tq]


def apply_attention_train(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                          positions: torch.Tensor, mask_kind: str = "causal",
                          prefix_len: int = 0,
                          window: Optional[int] = None,
                          use_chunked: bool = False) -> torch.Tensor:
    """GQA self-attention without a cache (the reference's
    ``apply_attention(cache=None)``, the training forward's): q/k/v with a
    single adapter's LoRA (``p["lora"]`` leaves (D, r) / (r, O)), RoPE at
    ``positions`` (B, T), then ``attention_core`` under ``_scores_mask``,
    or ``attention_chunked`` with ``use_chunked``.  No kernel runs here:
    the kernels have no backward.  x: (B, T, D); returns (B, T, D)."""
    B, T, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    lora = p.get("lora", {})
    s = cfg.lora.scaling if cfg.lora else 1.0
    q = dense(x, p["wq"], lora.get("q"), scaling=s)
    k = dense(x, p["wk"], lora.get("k"), scaling=s)
    v = dense(x, p["wv"], lora.get("v"), scaling=s)
    q = rope(q.reshape(B, T, H, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, T, K, hd), positions, cfg.rope_theta)
    v = v.reshape(B, T, K, hd)
    if use_chunked:
        out = attention_chunked(q, k, v, positions, positions,
                                kind=mask_kind, window=window,
                                prefix_len=prefix_len)
    else:
        mask = _scores_mask(positions, positions, mask_kind, window,
                            prefix_len)
        out = attention_core(q, k, v, mask)
    return dense(out.reshape(B, T, H * hd), p["wo"], lora.get("o"),
                 scaling=s)


def cross_attention_train(p: Params, cfg: ModelConfig, x: torch.Tensor,
                          enc_out: torch.Tensor) -> torch.Tensor:
    """The reference's cache-free ``_cross_attention``: queries from x
    (B, T, D), keys and values from the encoder's output (B, S, D), no
    RoPE, no LoRA, every key visible, through ``attention_core``."""
    B, T, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = dense(x, p["wq"]).reshape(B, T, H, hd)
    k = dense(enc_out, p["wk"]).reshape(B, -1, K, hd)
    v = dense(enc_out, p["wv"]).reshape(B, -1, K, hd)
    mask = x.new_zeros((B, T, k.shape[1]), dtype=torch.float32)
    out = attention_core(q, k, v, mask)
    return dense(out.reshape(B, T, H * hd), p["wo"])


def apply_encoder_attention(p: Params, cfg: ModelConfig,
                            x: torch.Tensor) -> torch.Tensor:
    """The encoder's cache-free bidirectional attention (the reference's
    ``apply_attention(mask_kind="bidir")`` over ``num_kv_heads =
    num_heads``): q, k, v (no LoRA), RoPE at positions ``[0, T)``, every
    key visible to every query through the flash kernel.  x: (B, T, D);
    returns (B, T, D)."""
    B, T, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim_
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    q = rope(dense(x, p["wq"]).reshape(B, T, H, hd), positions,
             cfg.rope_theta)
    k = rope(dense(x, p["wk"]).reshape(B, T, H, hd), positions,
             cfg.rope_theta)
    v = dense(x, p["wv"]).reshape(B, T, H, hd)
    out = flash_mha(q, k, v, causal=False)
    return dense(out.reshape(B, T, H * hd), p["wo"])


def apply_cross_attention(p: Params, cfg: ModelConfig, x: torch.Tensor,
                          cache: Dict[str, Any],
                          enc_out: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Cross-attention of the decoder's x (B, T, D) over the encoder's
    output: no RoPE, no LoRA, every key visible (the reference's
    ``_cross_attention``).

    Prefill (``enc_out`` (B, S, D) given): K/V = enc_out @ Wk / Wv are
    copied IN PLACE into the ring cache's ``xk`` / ``xv`` (B, S, K, hd),
    which a captured decode step reads at fixed addresses, and the T
    queries attend over them with the flash kernel (not causal).  Decode
    (``enc_out`` None, T == 1): the query attends over the cached K/V
    with the ring-decode kernel, whose slots ``xpos`` hold ``[0, S)`` and
    whose query sits at position S - 1, so every slot is visible."""
    B, T, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = dense(x, p["wq"]).reshape(B, T, H, hd)
    xk, xv = cache["xk"], cache["xv"]
    S = xk.shape[1]
    if enc_out is not None:
        k = dense(enc_out, p["wk"]).reshape(B, -1, K, hd)
        v = dense(enc_out, p["wv"]).reshape(B, -1, K, hd)
        if k.shape != xk.shape:
            raise ValueError(f"encoder output of {k.shape[1]} frames for a "
                             f"cross cache of {S}")
        xk.copy_(k)
        xv.copy_(v)
        out = flash_mha(q, k, v, causal=False)
    else:
        out = decode_gqa(q[:, 0], xk, xv, cache["xpos"], S - 1)[:, None]
    return dense(out.reshape(B, T, H * hd), p["wo"])


# ------------------------------------------------------------------------ MLPs
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh approximation) step by step in x's dtype, each
    op rounded as the reference's lowering rounds it."""
    # constants rounded to x's dtype, made on x's device (no host copy:
    # the captured dispatches run this)
    c = x.new_full((), math.sqrt(2.0 / math.pi))
    k = x.new_full((), 0.044715)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x * cdf


def apply_mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x @ Wg) * (x @ Wi)) @ Wo; squared ReLU:
    relu(x @ Wi)^2 @ Wo, the relu and then the square each rounded in the
    activation dtype, as the reference's ``jnp.square(jax.nn.relu(.))``;
    GELU: gelu(x @ Wi) @ Wo with ``jax.nn.gelu``'s tanh approximation
    (not torch's default erf form)."""
    if cfg.mlp_for == SWIGLU:
        h = F.silu(x @ p["wg"]["w"]) * (x @ p["wi"]["w"])
    elif cfg.mlp_for == SQRELU:
        h = torch.relu(x @ p["wi"]["w"])
        h = h * h
    elif cfg.mlp_for == GELU:
        h = _gelu_tanh(x @ p["wi"]["w"])
    else:
        raise ValueError(f"mlp {cfg.mlp_for!r} is not ported")
    return h @ p["wo"]["w"]


def apply_encoder_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The encoder's MLP: gelu(x @ Wi) @ Wo (tanh approximation)."""
    return _gelu_tanh(x @ p["wi"]["w"]) @ p["wo"]["w"]
