"""Mamba-2 SSD (state-space duality) block — the attention-free mixer
(port of ``repro/models/ssm.py``).

Prefill uses the chunked SSD algorithm (quadratic intra-chunk term plus a
linear inter-chunk recurrence, a sequential loop over chunks).  Decode is
the O(1) diagonal recurrence  h_t = exp(a·dt)·h_{t-1} + dt·(B_t ⊗ x_t),
y_t = C_t·h_t + D·x_t.  Plain PyTorch: the reference computes the block
with XLA ops, not a Pallas kernel.  [arXiv:2405.21060]
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_normal, apply_norm, causal_conv1d,
                                       matmul)
from repro_torch.models.moe import _silu
from repro_torch.models.rglru import _delta, _softplus

Params = Dict[str, Any]


def ssd_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device) -> Params:
    """Seeded parameters at the reference's init scales."""
    D, Di, S, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state_dim, \
        cfg.ssm_num_heads
    W = cfg.ssm_conv_width
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection -> [z | x | B | C | dt]
        "in_proj": {"w": _normal(gen, (D, 2 * Di + 2 * S + nh), dtype,
                                 1.0 / math.sqrt(D), device)},
        "conv": _normal(gen, (W, Di), dtype, 0.5, device),
        "a_log": torch.log(torch.linspace(1.0, float(nh), nh, **f32)),
        "dt_bias": torch.zeros((nh,), **f32),
        "d_skip": torch.ones((nh,), **f32),
        "gate_norm": {"scale": torch.ones((Di,), dtype=dtype,
                                          device=device)},
        "out_proj": {"w": _normal(gen, (Di, D), dtype, 1.0 / math.sqrt(Di),
                                  device)},
    }


def _split(t: torch.Tensor, cfg: ModelConfig):
    """[z | x | B | C | dt] along the last axis."""
    Di, S, nh = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_num_heads
    return torch.split(t, [Di, Di, S, S, nh], dim=-1)


def _segsum(dtA: torch.Tensor) -> torch.Tensor:
    """dtA: (..., Q).  Returns L (..., Q, Q): exp(sum_{j<k<=i} dtA_k) for
    i >= j, else 0."""
    Q = dtA.shape[-1]
    cs = torch.cumsum(dtA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]           # (..., i, j)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=dtA.device))
    return torch.where(mask, torch.exp(diff), torch.zeros_like(diff))


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    xh: (b, T, nh, hd); dt: (b, T, nh) (softplus'd, >= 0); a: (nh,) < 0;
    B, C: (b, T, S); h0: (b, nh, hd, S) float32 or None.  Blocks are
    ``chunk`` tokens at absolute multiples of ``chunk`` (never shrunk to
    T), so a prompt run whole and chunk at a time (slices a multiple of
    ``chunk``, carried h0) run the same per-block ops and the same
    sequential carry.  Tail padding is the dt = 0 identity.
    Returns (y (b, T, nh, hd) float32, h_final (b, nh, hd, S) float32)."""
    b, T, nh, hd = xh.shape
    S = B.shape[-1]
    Q = chunk
    T0 = T
    pad = (-T) % Q
    if pad:
        def zpad(t):
            return torch.cat([t, t.new_zeros((b, pad) + tuple(t.shape[2:]))],
                             dim=1)
        xh, dt, B, C = zpad(xh), zpad(dt), zpad(B), zpad(C)
        T = T + pad
    nc = T // Q
    xc = xh.reshape(b, nc, Q, nh, hd).float()
    dtc = dt.reshape(b, nc, Q, nh).float()
    Bc = B.reshape(b, nc, Q, S).float()
    Cc = C.reshape(b, nc, Q, S).float()

    dtA = dtc * a[None, None, None, :]                   # log decay
    L = _segsum(dtA.permute(0, 1, 3, 2))                 # (b, nc, nh, Q, Q)

    # intra-chunk (quadratic) term: Y[i] = sum_{j<=i} L[i,j] (C_i.B_j) dt_j x_j
    CB = torch.einsum("bnis,bnjs->bnij", Cc, Bc)         # (b, nc, Q, Q)
    M = CB[:, :, None] * L                               # (b, nc, nh, Q, Q)
    y_intra = torch.einsum("bnhij,bnjh,bnjhd->bnihd", M, dtc, xc)

    # chunk summaries: S_n = sum_j exp(cs_Q - cs_j) dt_j B_j ⊗ x_j
    cs = torch.cumsum(dtA, dim=2)                        # (b, nc, Q, nh)
    decay_to_end = torch.exp(cs[:, :, -1:, :] - cs)
    states = torch.einsum("bnqh,bnqh,bnqs,bnqhd->bnhds",
                          decay_to_end, dtc, Bc, xc)
    chunk_decay = torch.exp(cs[:, :, -1, :])             # (b, nc, nh)

    # inter-chunk recurrence over chunk states: h_prev[n] = state BEFORE n
    h = torch.zeros((b, nh, hd, S), dtype=torch.float32,
                    device=xh.device) if h0 is None else h0
    prev = []
    for n in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + states[:, n]
    h_prev = torch.stack(prev, dim=1)                    # (b, nc, nh, hd, S)

    # inter-chunk term: Y[i] += exp(cs_i) * C_i · h_prev
    y_inter = torch.einsum("bnqs,bnhds,bnqh->bnqhd", Cc, h_prev,
                           torch.exp(cs))
    y = (y_intra + y_inter).reshape(b, T, nh, hd)
    return y[:, :T0], h


def apply_ssd(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              state: Optional[Params] = None,
              seq_lens: Optional[torch.Tensor] = None,
              lora: Optional[Params] = None, lora_scaling: float = 1.0,
              adapter_idx: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Params]:
    """The full Mamba-2 block.  x: (B, T, D).

    state: {"conv": (B, W-1, Di), "ssm": (B, nh, hd, S) float32}.  T == 1
    with state is the O(1) decode recurrence; T > 1 with state is
    chunked-prefill continuation: the chunked scan seeds from the carried
    SSM state, and ``seq_lens`` (B,) masks chunk-tail padding to the
    dt = 0 identity, so the returned state is the state after each row's
    last real token.  Returns (out, new state)."""
    Bsz, T, _ = x.shape
    Di, nh, hd = cfg.d_inner, cfg.ssm_num_heads, cfg.ssm_head_dim
    z, xs, Bm, Cm, dt = _split(matmul(x, p["in_proj"]["w"]), cfg)
    if lora is not None and "in" in lora:
        ez, exs, eB, eC, edt = _split(
            _delta(x, lora["in"], lora_scaling, adapter_idx), cfg)
        z, xs, Bm, Cm, dt = z + ez, xs + exs, Bm + eB, Cm + eC, dt + edt

    xs, new_conv = causal_conv1d(
        xs, p["conv"], state["conv"] if state is not None else None,
        seq_lens=seq_lens)
    xs = _silu(xs)

    dt = _softplus(dt.float() + p["dt_bias"])            # (B, T, nh)
    if seq_lens is not None:
        valid = (torch.arange(T, device=x.device)[None, :, None]
                 < seq_lens[:, None, None])
        dt = torch.where(valid, dt, torch.zeros_like(dt))  # identity steps
    a = -torch.exp(p["a_log"])                           # (nh,) < 0
    xh = xs.reshape(Bsz, T, nh, hd)

    if state is None or T > 1:
        h0 = state["ssm"] if state is not None else None
        y, h_final = ssd_chunked(xh, dt, a, Bm, Cm, cfg.ssm_chunk, h0=h0)
    else:
        # O(1) decode recurrence (T == 1)
        dA = torch.exp(dt[:, 0] * a[None, :])            # (B, nh)
        dBx = torch.einsum("bh,bs,bhd->bhds", dt[:, 0], Bm[:, 0].float(),
                           xh[:, 0].float())
        h_final = state["ssm"] * dA[..., None, None] + dBx
        y = torch.einsum("bhds,bs->bhd", h_final,
                         Cm[:, 0].float())[:, None]       # (B, 1, nh, hd)

    y = y + p["d_skip"][None, None, :, None] * xh.float()
    y = y.reshape(Bsz, T, Di).to(x.dtype)
    y = apply_norm(y * _silu(z), p["gate_norm"], "rmsnorm")
    out = matmul(y, p["out_proj"]["w"])
    if lora is not None and "out" in lora:
        out = out + _delta(y, lora["out"], lora_scaling,
                           adapter_idx).to(out.dtype)
    return out, {"conv": new_conv, "ssm": h_final}
