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
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.decode_attention.ops import decode_gqa
from repro_torch.kernels.flash_attention.ops import flash_mha
from repro_torch.kernels.paged_attention.ops import paged_decode_gqa
from repro_torch.kernels.paged_prefill.ops import paged_prefill_gqa
from repro_torch.kernels.sgmv.ops import sgmv_tokens
from repro_torch.models.config import GELU, SQRELU, SWIGLU, ModelConfig

Params = Dict[str, Any]


def _normal(gen: Optional[torch.Generator], shape, dtype, scale: float,
            device) -> torch.Tensor:
    """N(0, scale^2) drawn in float32 from ``gen``, cast to ``dtype``
    (scaled in place: one float32 copy of the leaf at a time).  On the
    meta device it allocates nothing and draws nothing (``gen`` may be
    None): the dry run's abstract params."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
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


def _split(t: torch.Tensor, pl, dim: int, mesh, i: int) -> bool:
    """Whether ``t``'s dim ``dim`` divides over mesh dim ``i`` on top of
    the mesh dims that ``pl`` already splits it over."""
    n = mesh.size(i)
    for j, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == dim:
            n *= mesh.size(j)
    return t.shape[dim] % n == 0


def _placed_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` on DTensors after ``matmul``'s placement rule."""
    mesh = (w if isinstance(w, DTensor) else x).device_mesh
    rep = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, rep, run_check=False)
    xpl, wpl = list(x.placements), list(w.placements)
    feat, rows, cols = x.ndim - 1, w.ndim - 2, w.ndim - 1
    for i in range(mesh.ndim):
        if mesh.size(i) == 1:
            continue
        px, pw = xpl[i], wpl[i]
        x_feat = isinstance(px, Shard) and px.dim == feat
        x_other = isinstance(px, Shard) and not x_feat
        if isinstance(pw, Shard) and pw.dim == rows and not x_feat:
            if not x_other and _split(x, xpl, feat, mesh, i):
                xpl[i] = Shard(feat)
            else:
                wpl[i] = Replicate()
        elif isinstance(pw, Shard) and pw.dim == cols and x_other:
            wpl[i] = Replicate()
        elif pw.is_replicate() and not (x_feat or x_other) \
                and _split(x, xpl, 0, mesh, i):
            xpl[i] = Shard(0)
    if xpl != list(x.placements):
        x = x.redistribute(mesh, xpl)
    if wpl != list(w.placements):
        w = w.redistribute(mesh, wpl)
    return x @ w


class _PlacedMatmul(torch.autograd.Function):
    """``_placed_mm`` whose backward products are placed by the same rule
    (left to itself, torch 2.11's DTensor multiplied a partial-sum
    gradient by a weight it gathered whole, on every rank of the model
    group)."""

    @staticmethod
    def forward(ctx, x, w):
        # x is saved only for w's gradient, and the weight is kept as an
        # attribute: remat's recompute (``torch.utils.checkpoint``) stops
        # once every saved tensor is back, and a custom Function packs
        # what it saves only after its forward has run, so a saved weight
        # would make the recompute run the layer's last product too
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None)
        ctx.w = w
        ctx.x_is_dtensor = isinstance(x, DTensor)
        return _placed_mm(x, w)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        w = ctx.w
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _placed_mm(g, w.transpose(-2, -1))
            if not ctx.x_is_dtensor:
                dx = dx.full_tensor()
        if ctx.needs_input_grad[1]:
            dw = _placed_mm(x.reshape(-1, x.shape[-1]).transpose(0, 1),
                            g.reshape(-1, g.shape[-1]))
            if not isinstance(w, DTensor):
                dw = dw.full_tensor()
        return dx, dw


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for a weight w (d_in, d_out).  DTensor operands are first
    placed so that no mesh dim repeats the product on each of its ranks,
    whatever DTensor's own strategy search would pick (its choice differs
    between torch releases), and so are the backward's products.  On each
    mesh dim where w's rows, the contraction dim, are split: if x is split
    on its features too the product is row-parallel and stays; if x is
    split on another dim, w's rows are gathered there first (FSDP's
    per-layer weight all-gather, which GSPMD inserts for the reference's
    fsdp2d policy); if x is whole or a partial sum there, x's features are
    split instead (a slice, or a reduce-scatter), and the product is
    row-parallel.  Where w's columns are split and x is split on a
    leading dim, w is gathered (FSDP again).  Where w is whole and x is
    whole or a partial sum, x's first dim is split if it divides
    (splitting the sequence instead moved more bytes in a prefill than
    the product it spared).  Plain tensors pass to ``@`` unchanged."""
    if not isinstance(w, DTensor) and not isinstance(x, DTensor):
        return x @ w
    return _PlacedMatmul.apply(x, w)


def dense(x: torch.Tensor, p: Params, lora: Optional[Params] = None, *,
          scaling: float = 1.0,
          adapter_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x @ W (+ b) (+ LoRA delta) — unmerged LoRA.

    ``lora`` holds {"a": (D, r), "b": (r, O)} for a single adapter
    (``adapter_idx`` None: y + scaling * ((x @ A) @ B)), or a stacked bank
    {"a": (N, D, r), "b": (N, r, O)} with per-row ``adapter_idx`` (the SGMV
    delta, cast to y's dtype)."""
    y = matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"]
    if lora is not None:
        if adapter_idx is None:
            if lora["a"].dim() != 2:
                raise ValueError("a LoRA bank needs per-row adapter_idx")
            y = y + scaling * matmul(matmul(x, lora["a"]), lora["b"])
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
def _heads(t: torch.Tensor, B: int, T: int, n: int, hd: int) -> torch.Tensor:
    """(B, T, n * hd) -> (B, T, n, hd).  A DTensor whose feature dim is
    sharded over a mesh dim that does not divide n (8 kv heads over a
    16-way "model") is first gathered on that mesh dim: DTensor cannot
    split a dim it holds unevenly."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.ndim - 1
        pl = [Replicate() if isinstance(p, Shard) and p.dim == last
              and n % mesh.size(i) else p
              for i, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(B, T, n, hd)


def _per_shard(fn, args, dims, *, lead: int, out_dims, **kwargs):
    """Run ``fn`` (a kernel wrapper, or the training forward's plain
    attention) shard by shard on DTensor inputs: each device takes its own
    rows and heads, as the reference's per-shard math does.  ``dims[i]`` is
    arg i's (batch dim, head dim), either None.  On a mesh dim where
    ``args[lead]`` is split on its batch (head) dim, every arg is split on
    its own batch (head) dim.  On a mesh dim where it is not (replicated,
    a partial sum, or split on another dim) the args are split on their
    head dim if the lead's heads divide there, else on their batch dim if
    its rows divide, and replicated only where neither divides: no device
    repeats another's work that a split could spare.  Plain tensors are
    taken as replicated; non-tensors pass through.  Returns the output as
    a DTensor placed by ``out_dims``.  The redistributions are DTensor's
    and show among its collectives."""
    ref = args[lead]
    mesh = next(a for a in args if isinstance(a, DTensor)).device_mesh
    pls = (ref.placements if isinstance(ref, DTensor)
           else [Replicate()] * mesh.ndim)
    kinds = []
    for p in pls:
        kind = None
        if isinstance(p, Shard):
            kind = {dims[lead][0]: 0, dims[lead][1]: 1}.get(p.dim)
        kinds.append(kind)
    left = [ref.shape[d] if d is not None else 1 for d in dims[lead]]
    for i, kind in enumerate(kinds):
        if kind is not None:
            left[kind] //= mesh.size(i)
    for i, kind in enumerate(kinds):
        if kind is None:
            n = mesh.size(i)
            kind = next((k for k in (1, 0) if dims[lead][k] is not None
                         and left[k] % n == 0), None)
            if kind is not None:
                left[kind] //= n
                kinds[i] = kind

    def placements(d):
        return [Shard(d[k]) if k is not None and d[k] is not None
                else Replicate() for k in kinds]

    local = []
    for a, d in zip(args, dims):
        if not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        want = placements(d)
        if list(a.placements) != want:
            a = a.redistribute(mesh, want)
        local.append(a.to_local())
    out = fn(*local, **kwargs)
    return DTensor.from_local(out, mesh, placements(out_dims),
                              run_check=False)


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
    if isinstance(cache["k"], DTensor):
        return _ring_attention_per_shard(cache, q, k, v, positions, window,
                                         prefix_len)
    _ring_write(cache, k, v, positions)
    if q.shape[1] > 1:
        return flash_mha(q, k, v, causal=True, window=window,
                         prefix_len=prefix_len)
    return decode_gqa(q[:, 0], cache["k"], cache["v"], cache["slot_pos"],
                      positions[0, 0], window=window)[:, None]


def _ring_write(cache: Dict[str, Any], k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor) -> None:
    """``_ring_attention``'s writes on plain tensors: the T new K/V and
    their positions into the ring, in place, and ``idx`` advanced by T."""
    T = k.shape[1]
    S = cache["k"].shape[1]
    idx = cache["idx"]
    if T > 1 and idx != 0:
        raise ValueError(f"ring prefill needs a fresh cache (idx 0, got "
                         f"{idx}): queries at positions [0, T) would "
                         f"attend to older slots")
    if T > S:
        cache["k"].copy_(k[:, -S:])
        cache["v"].copy_(v[:, -S:])
        cache["slot_pos"].copy_(positions[0, -S:])
    elif T > 1:
        cache["k"][:, :T] = k.to(cache["k"].dtype)
        cache["v"][:, :T] = v.to(cache["v"].dtype)
        cache["slot_pos"][:T] = positions[0]
    else:
        slot = torch.remainder(positions[0], S).long()           # (1,)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        cache["slot_pos"].index_copy_(0, slot, positions[0])
    cache["idx"] = idx + T


def _ring_split(pl, mesh, B: int, H: int, K: int, T: int, S: int):
    """How ``_ring_attention_per_shard`` splits the attention on each mesh
    dim that ``pl`` (the ring's batch and kv-head shards) leaves whole:
    "heads" where the query heads left divide it and each share lies in
    whole kv groups or inside one; else "rows" where the rows left divide
    it; else, at decode, "kv" where the slots left divide it: each rank
    attends over its own slots; else, at prefill, "queries" on the first
    such dim whose 2n divides T: each rank takes two chunks of T / 2n
    queries (``_zigzag_prefill``); else None (every rank repeats the
    attention: a prefill whose heads and rows do not divide and whose T
    does not divide 2n, or a second such dim).  A split composes after
    the ring's own shards of that tensor dim (DTensor's chunk order), so
    it is taken only on a mesh dim after them."""
    G = H // K
    left = {0: B, 1: S, 2: H}
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            left[p.dim] //= mesh.size(i)
    kinds = []
    for i, p in enumerate(pl):
        n = mesh.size(i)
        after = {d: all(j < i for j, pj in enumerate(pl)
                        if isinstance(pj, Shard) and pj.dim == d)
                 for d in (0, 2)}
        kind = None
        if n == 1 or isinstance(p, Shard):
            pass
        elif (after[2] and left[2] % n == 0
              and ((left[2] // n) % G == 0 or G % (left[2] // n) == 0)):
            kind, left[2] = "heads", left[2] // n
        elif after[0] and left[0] % n == 0:
            kind, left[0] = "rows", left[0] // n
        elif T == 1 and left[1] % n == 0:
            kind, left[1] = "kv", left[1] // n
        elif T > 1 and "queries" not in kinds and T % (2 * n) == 0:
            kind = "queries"
        kinds.append(kind)
    return kinds


def _ring_attention_per_shard(cache: Dict[str, Any], q, k, v, positions,
                              window: Optional[int],
                              prefix_len: int) -> torch.Tensor:
    """``_ring_attention`` on a DTensor ring cache, per shard.  Each
    device writes its own rows and kv heads (the cache's batch and head
    sharding; a ring sharded on the sequence or head_dim is gathered on
    those mesh dims for the write and split again after it).  The
    attention follows ``_per_shard``'s rule, that no device repeats
    another's work that a split could spare (``_ring_split``): on a mesh
    dim the ring leaves whole, each rank takes its share of the query
    heads and the kv heads they read, or of the rows, or, at decode, of
    the slots, whose (max, sum, out) partials are merged across the group
    as ``split_kv_merge`` merges partitions (two all-reduces of (B, H)
    statistics and outputs), or, at prefill, of the queries.  A share of
    rows or of queries is gathered again after the kernel, so the output
    reaches the out projection as the ring's kv-head split would: whole
    rows and positions, heads split.  DTensor's own in-place
    ops on a sharded ring (setitem, ``index_copy_``) may move its
    placements, so none of them runs on the DTensors."""
    ck = cache["k"]
    mesh = ck.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in ck.placements]
    rep = [Replicate()] * mesh.ndim

    def local(t, want):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, rep, run_check=False)
        if list(t.placements) != want:
            t = t.redistribute(mesh, want)
        return t.to_local()

    B, T, H, _ = q.shape
    K = k.shape[2]
    kinds = _ring_split(pl, mesh, B, H, K, T, ck.shape[1])
    qpl = [Shard(2) if kind == "heads" else Shard(0) if kind == "rows"
           else p for p, kind in zip(pl, kinds)]

    lc = {"k": local(ck, pl), "v": local(cache["v"], pl),
          "slot_pos": local(cache["slot_pos"], rep), "idx": cache["idx"]}
    if isinstance(positions, DTensor):
        positions = positions.full_tensor()
    kl, vl = local(k, pl), local(v, pl)
    _ring_write(lc, kl, vl, positions)
    for name, want in (("k", pl), ("v", pl), ("slot_pos", rep)):
        if list(cache[name].placements) != want:
            cache[name] = DTensor.from_local(
                lc[name], mesh, want, run_check=False).redistribute(
                    mesh, cache[name].placements)
    cache["idx"] = lc["idx"]

    ql = local(q, qpl)
    if T > 1:
        kv = [kl, vl]
    else:
        kv = [lc["k"], lc["v"], lc["slot_pos"]]
    G = H // K
    h, off = H, 0               # query heads left, offset in the kv heads
    for i, p in enumerate(pl):
        if isinstance(p, Shard) and p.dim == 2:
            h //= mesh.size(i)
    for i, kind in enumerate(kinds):
        if kind is None:
            continue
        n, c = mesh.size(i), mesh.get_local_rank(i)
        if kind == "heads":
            h //= n
            off += c * h
        elif kind == "rows":
            b = kv[0].shape[0] // n
            kv[:2] = [t.narrow(0, c * b, b) for t in kv[:2]]
        elif kind == "kv":
            s = kv[0].shape[1] // n
            kv = [t.narrow(1, c * s, s) for t in kv[:2]] \
                + [kv[2].narrow(0, c * s, s)]
    kv[:2] = [t.narrow(2, off // G, max(1, h // G)).contiguous()
              for t in kv[:2]]
    kv_dims = [i for i, kind in enumerate(kinds) if kind == "kv"]
    if "queries" in kinds:
        out = _zigzag_prefill(ql, kv[0], kv[1], mesh, kinds.index("queries"),
                              window, prefix_len)
    elif T > 1:
        out = flash_mha(ql, kv[0], kv[1], causal=True, window=window,
                        prefix_len=prefix_len)
    elif not kv_dims:
        out = decode_gqa(ql[:, 0], *kv, positions[0, 0],
                         window=window)[:, None]
    else:
        o, lse = decode_gqa(ql[:, 0], *kv, positions[0, 0], window=window,
                            return_lse=True)
        out = _merge_partials(o, lse, mesh, kv_dims)[:, None]
    res = DTensor.from_local(out, mesh, qpl, run_check=False)
    if "rows" in kinds:
        res = res.redistribute(mesh, [Replicate() if kind == "rows" else p
                                      for p, kind in zip(qpl, kinds)])
    return res


def _zigzag_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                    dim: int, window: Optional[int],
                    prefix_len: int) -> torch.Tensor:
    """Causal prefill of all T queries split over mesh ``dim``'s n ranks.
    T is cut into 2n chunks of T / 2n; rank c takes chunks c and 2n-1-c,
    so each rank's causal pairs are 1/n of the whole (an early chunk's
    short walk pairs with a late one's long walk).  Each chunk goes to the
    flash kernel at its query offset over the keys up to its last query
    (or to the prefix's end); the chunks are gathered over the group and
    put back in position order: (B, T, H, hd) on every rank."""
    n, c = mesh.size(dim), mesh.get_local_rank(dim)
    B, T = q.shape[:2]
    m = T // (2 * n)
    outs = []
    for j in (c, 2 * n - 1 - c):
        end = min(T, max((j + 1) * m, prefix_len))
        outs.append(flash_mha(
            q[:, j * m:(j + 1) * m].contiguous(), k[:, :end].contiguous(),
            v[:, :end].contiguous(), causal=True, window=window,
            prefix_len=prefix_len, q_offset=j * m))
    mine = torch.cat(outs, 1)
    got = DTensor.from_local(
        mine, mesh, [Shard(1) if i == dim else Replicate()
                     for i in range(mesh.ndim)], run_check=False
    ).redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    # the group's chunks arrive in rank order: 0, 2n-1, 1, 2n-2, ...
    slot = [2 * j if j < n else 2 * (2 * n - 1 - j) + 1
            for j in range(2 * n)]
    got = got.reshape(B, 2 * n, m, *got.shape[2:])[:, slot]
    return got.reshape(B, T, *got.shape[3:])


def _merge_partials(o: torch.Tensor, lse: torch.Tensor, mesh,
                    dims) -> torch.Tensor:
    """Merge each rank's attention over its own slots, ``o`` (B, H, hd)
    normalised by its ``lse`` (B, H, log of the sum of exp scores, -inf
    with no slot), across the mesh ``dims``: out = sum_r e^(lse_r - L) o_r
    / sum_r e^(lse_r - L) with L the largest lse, as ``split_kv_merge``
    merges a kernel's partitions."""
    def reduce(t, op):
        pl = [Partial(op) if i in dims else Replicate()
              for i in range(mesh.ndim)]
        return DTensor.from_local(t, mesh, pl, run_check=False).redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()

    top = reduce(lse, "max")
    w = torch.exp(lse - torch.where(torch.isinf(top), 0.0, top))[..., None]
    tot = reduce(torch.cat([o.float() * w, w], -1), "sum")
    return (tot[..., :-1] / tot[..., -1:].clamp(min=1e-30)).to(o.dtype)


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
    q = rope(_heads(q, B, T, H, hd), positions, cfg.rope_theta)
    k = rope(_heads(k, B, T, K, hd), positions, cfg.rope_theta)
    v = _heads(v, B, T, K, hd)
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
    q = rope(_heads(q, B, T, H, hd), positions, cfg.rope_theta)
    k = rope(_heads(k, B, T, K, hd), positions, cfg.rope_theta)
    v = _heads(v, B, T, K, hd)

    def attend(q, k, v, q_pos, k_pos):
        if use_chunked:
            return attention_chunked(q, k, v, q_pos, k_pos, kind=mask_kind,
                                     window=window, prefix_len=prefix_len)
        mask = _scores_mask(q_pos, k_pos, mask_kind, window, prefix_len)
        return attention_core(q, k, v, mask)

    if isinstance(k, DTensor):
        # per shard, each device's rows and heads (as the kernels run):
        # DTensor's own propagation of the 5-D score products is slow and
        # gathers what the per-head math never needs
        out = _per_shard(attend, (q, k, v, positions, positions),
                                 ((0, 2),) * 3 + ((0, None),) * 2, lead=1,
                                 out_dims=(0, 2))
    else:
        out = attend(q, k, v, positions, positions)
    return dense(out.reshape(B, T, H * hd), p["wo"], lora.get("o"),
                 scaling=s)


def cross_attention_train(p: Params, cfg: ModelConfig, x: torch.Tensor,
                          enc_out: torch.Tensor) -> torch.Tensor:
    """The reference's cache-free ``_cross_attention``: queries from x
    (B, T, D), keys and values from the encoder's output (B, S, D), no
    RoPE, no LoRA, every key visible, through ``attention_core``."""
    B, T, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    q = _heads(dense(x, p["wq"]), B, T, H, hd)
    k = _heads(dense(enc_out, p["wk"]), B, -1, K, hd)
    v = _heads(dense(enc_out, p["wv"]), B, -1, K, hd)
    mask = torch.zeros((B, T, k.shape[1]), dtype=torch.float32,
                       device=x.device)
    if isinstance(k, DTensor):
        out = _per_shard(attention_core, (q, k, v, mask),
                                 ((0, 2),) * 3 + ((0, None),), lead=1,
                                 out_dims=(0, 2))
    else:
        out = attention_core(q, k, v, mask)
    return dense(out.reshape(B, T, H * hd), p["wo"])


def _flash(q, k, v, **kwargs) -> torch.Tensor:
    """``flash_mha``, per shard on DTensors (``_per_shard``)."""
    if isinstance(k, DTensor):
        return _per_shard(flash_mha, (q, k, v), ((0, 2),) * 3, lead=1,
                          out_dims=(0, 2), **kwargs)
    return flash_mha(q, k, v, **kwargs)


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
    q = rope(_heads(dense(x, p["wq"]), B, T, H, hd), positions,
             cfg.rope_theta)
    k = rope(_heads(dense(x, p["wk"]), B, T, H, hd), positions,
             cfg.rope_theta)
    v = _heads(dense(x, p["wv"]), B, T, H, hd)
    out = _flash(q, k, v, causal=False)
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
    q = _heads(dense(x, p["wq"]), B, T, H, hd)
    xk, xv = cache["xk"], cache["xv"]
    S = xk.shape[1]
    if enc_out is not None:
        k = _heads(dense(enc_out, p["wk"]), B, -1, K, hd)
        v = _heads(dense(enc_out, p["wv"]), B, -1, K, hd)
        if k.shape != xk.shape:
            raise ValueError(f"encoder output of {k.shape[1]} frames for a "
                             f"cross cache of {S}")
        xk.copy_(k)
        xv.copy_(v)
        out = _flash(q, k, v, causal=False)
    elif isinstance(xk, DTensor):
        out = _per_shard(decode_gqa, (q[:, 0], xk, xv, cache["xpos"], S - 1),
                         ((0, 1), (0, 2), (0, 2), (None, None),
                          (None, None)), lead=1, out_dims=(0, 1))[:, None]
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
        h = F.silu(matmul(x, p["wg"]["w"])) * matmul(x, p["wi"]["w"])
    elif cfg.mlp_for == SQRELU:
        h = torch.relu(matmul(x, p["wi"]["w"]))
        h = h * h
    elif cfg.mlp_for == GELU:
        h = _gelu_tanh(matmul(x, p["wi"]["w"]))
    else:
        raise ValueError(f"mlp {cfg.mlp_for!r} is not ported")
    return matmul(h, p["wo"]["w"])


def apply_encoder_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """The encoder's MLP: gelu(x @ Wi) @ Wo (tanh approximation)."""
    return matmul(_gelu_tanh(matmul(x, p["wi"]["w"])), p["wo"]["w"])
