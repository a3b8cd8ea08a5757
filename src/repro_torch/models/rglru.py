"""RG-LRU recurrent block (Griffin / RecurrentGemma hybrid mixer; port of
``repro/models/rglru.py``).

    r_t = σ(W_a x_t + b_a)            recurrence gate
    i_t = σ(W_x x_t + b_x)            input gate
    a_t = exp(c · log(σ(Λ)) · r_t)    per-channel decay, c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t)

Prefill evaluates the diagonal recurrence block-chunked: a log-depth scan
inside each ``ssm_chunk``-token block (plain PyTorch: the reference's
``associative_scan`` is no Pallas kernel) and a sequential carry across
blocks.  A block's ops depend only on its own values and the carry, so a
prompt run whole and the same prompt run chunk at a time (serving
chunked prefill, chunk a multiple of ``ssm_chunk``) execute the same
float ops and give the same bits.  Decode is one step.  The full block
is conv1d + RG-LRU on one branch, GeLU (tanh approximation, as
``jax.nn.gelu``'s default) on the other, multiplied and projected out.
[arXiv:2402.19427]
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_gelu_tanh, _normal, causal_conv1d,
                                       lora_delta, matmul)

Params = Dict[str, Any]
_C = 8.0


def rglru_init(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device) -> Params:
    """Seeded parameters at the reference's init scales."""
    D, Di, W = cfg.d_model, cfg.d_inner, cfg.ssm_conv_width
    s, si = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Di)

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return {
        "w_branch": {"w": _normal(gen, (D, Di), dtype, s, device)},
        "w_gelu": {"w": _normal(gen, (D, Di), dtype, s, device)},
        "conv": _normal(gen, (W, Di), dtype, 0.5, device),
        "w_a": {"w": _normal(gen, (Di, Di), dtype, si, device),
                "b": zeros(Di)},
        "w_x": {"w": _normal(gen, (Di, Di), dtype, si, device),
                "b": zeros(Di)},
        # Λ so that σ(Λ)^c spans slow and fast decays
        "lam": torch.linspace(2.0, 6.0, Di, dtype=torch.float32,
                              device=device),
        "out": {"w": _normal(gen, (Di, D), dtype, si, device)},
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) as the reference lowers
    it: max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))


def _gates(p: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    r = torch.sigmoid(matmul(x, p["w_a"]["w"]) + p["w_a"]["b"]).float()
    i = torch.sigmoid(matmul(x, p["w_x"]["w"]) + p["w_x"]["b"]).float()
    log_a0 = -_softplus(-p["lam"])                       # log σ(Λ) < 0
    a = torch.exp(_C * log_a0 * r)                       # (B, T, Di)
    return a, i


def rglru_scan(a: torch.Tensor, gated_x: torch.Tensor, h0: torch.Tensor,
               block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + b_t over aligned ``block``-token blocks.

    A log-depth (Hillis-Steele) scan INSIDE each block, a sequential carry
    across blocks seeded by ``h0``.  The tail pads with the recurrence
    identity (a = 1, b = 0).  a, b: (B, T, Di) float32; h0: (B, Di)
    float32.  Returns (h (B, T, Di), h_last (B, Di))."""
    B, T, Di = a.shape
    Q = block
    padn = (-T) % Q
    if padn:
        a = torch.cat([a, a.new_ones((B, padn, Di))], dim=1)
        gated_x = torch.cat([gated_x, gated_x.new_zeros((B, padn, Di))],
                            dim=1)
    nc = (T + padn) // Q
    ca = a.reshape(B, nc, Q, Di)
    cb = gated_x.reshape(B, nc, Q, Di)
    d = 1
    while d < Q:
        # combine (a1, b1) at t - d with (a2, b2) at t: (a1 a2, b1 a2 + b2)
        a_new = ca[:, :, d:] * ca[:, :, :-d]
        b_new = cb[:, :, :-d] * ca[:, :, d:] + cb[:, :, d:]
        ca = torch.cat([ca[:, :, :d], a_new], dim=2)
        cb = torch.cat([cb[:, :, :d], b_new], dim=2)
        d *= 2
    h = h0
    outs = []
    for n in range(nc):
        out = cb[:, n] + ca[:, n] * h[:, None]
        h = out[:, -1]
        outs.append(out)
    hs = torch.stack(outs, dim=1).reshape(B, nc * Q, Di)
    return hs[:, :T], h


def apply_rglru_block(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                      state: Optional[Params] = None,
                      seq_lens: Optional[torch.Tensor] = None,
                      lora: Optional[Params] = None,
                      lora_scaling: float = 1.0,
                      adapter_idx: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, Params]:
    """x: (B, T, D).  state: {"conv": (B, W-1, Di), "h": (B, Di) float32}.

    T == 1 with state is the decode recurrence.  T > 1 with state is
    chunked-prefill continuation: the scan seeds from the carried h, and
    ``seq_lens`` (B,) marks each row's valid-token count — later positions
    are chunk-tail padding, masked to the identity so the returned state
    is the state after the last REAL token.  ``lora`` holds the in/out
    banks ((N, D, r), (N, r, O)), applied per row through SGMV with
    ``adapter_idx`` (per token when T > 1).  Returns (out, new state)."""
    u = matmul(x, p["w_branch"]["w"])
    if lora is not None and "in" in lora:
        u = u + _delta(x, lora["in"], lora_scaling, adapter_idx).to(u.dtype)
    u, new_conv = causal_conv1d(
        u, p["conv"], state["conv"] if state is not None else None,
        seq_lens=seq_lens)
    a, i = _gates(p, u)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i * u.float()

    B, T = x.shape[:2]
    if state is not None and T == 1:
        h = a * state["h"][:, None] + gated               # decode step
        h_last = h[:, -1]
    else:
        h0 = state["h"] if state is not None else \
            torch.zeros((B, a.shape[-1]), dtype=torch.float32,
                        device=x.device)
        if seq_lens is not None:
            valid = (torch.arange(T, device=x.device)[None, :, None]
                     < seq_lens[:, None, None])
            a = torch.where(valid, a, torch.ones_like(a))   # identity steps
            gated = torch.where(valid, gated, torch.zeros_like(gated))
        h, h_last = rglru_scan(a, gated, h0, cfg.ssm_chunk)

    g = _gelu_tanh(matmul(x, p["w_gelu"]["w"])).float()
    y = (h * g).to(x.dtype)
    out = matmul(y, p["out"]["w"])
    if lora is not None and "out" in lora:
        out = out + _delta(y, lora["out"], lora_scaling,
                           adapter_idx).to(out.dtype)
    return out, {"conv": new_conv, "h": h_last}


def _delta(x: torch.Tensor, lora: Params, scaling: float,
           adapter_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """The LoRA delta of one in/out site: a single adapter's (D, r), (r, O)
    pair without ids, else the bank's per-row SGMV delta."""
    if adapter_idx is None:
        return scaling * matmul(matmul(x, lora["a"]), lora["b"])
    return lora_delta(x, lora, adapter_idx, scaling=scaling)
