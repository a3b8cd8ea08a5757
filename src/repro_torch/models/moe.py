"""Mixture-of-Experts MLP (port of ``repro/models/moe.py``): top-k router
and the expert products.

The reference sorts tokens by their assigned expert and runs
``jax.lax.ragged_dot`` (an XLA grouped product, not a Pallas kernel), so
its compiled FLOPs reflect only the active experts.  The group sizes of
such a product depend on the data, and a CUDA graph cannot read them
without a grouped GEMM that takes its offsets on the device.  So the
port's dropless path runs EVERY expert over every row, one batched
product per weight, and combines with weights that are zero for the
experts a row did not choose: E/k times the active FLOPs, and the same
weight bytes whenever every expert is chosen by some row (a decode batch
of 8 rows over 8 experts top-2 nearly always chooses all of them).

The combine adds the experts' contributions in ascending expert order, in
the output dtype: the order the reference's stable ``argsort`` +
``.at[token_of].add`` applies them, so for k = 2 the sum rounds exactly as
the reference's does (an unchosen expert adds an exact zero).  Rounding
follows the reference: router logits are a model-dtype product then
float32; each expert product is rounded to the model dtype; ``silu(g) * i``
is in the model dtype, ``silu`` as the reference's XLA graph spells it
(``g * (1 / (1 + exp(-g)))``, each step rounded); the combine weight is
cast to the output dtype before the multiply.

Top-k: ``lax.top_k`` takes the lower index on ties, and bf16 logits over 8
experts do tie.  ``torch.topk`` leaves ties unspecified on CUDA, so the
port takes the first k of a stable descending sort.

Everything here is capture-safe: no host read, no data-sized shape.

Multi-device routing (the reference's ``set_parallel_mesh`` and
``_apply_moe_shard_map``): with a mesh set, ``apply_moe`` runs
``_apply_moe_parallel``, where each data shard routes only its own tokens
against experts sliced on F over "model" and one sum over the model group
completes the products; the aux losses are averaged over the data axes.
It runs on DTensors (or on plain tensors, taken as replicated) through
explicit collectives on the mesh's groups.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
from torch.distributed import _functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import _normal

Params = Dict[str, Any]


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype,
             device) -> Params:
    """Router and expert weights at the reference's scales: router and
    ``wi``/``wg`` N(0, 1/D), ``wo`` N(0, 1/F)."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale = 1.0 / math.sqrt(D)
    return {
        "router": {"w": _normal(gen, (D, E), dtype, scale, device)},
        "wi": _normal(gen, (E, D, Fd), dtype, scale, device),
        "wg": _normal(gen, (E, D, Fd), dtype, scale, device),
        "wo": _normal(gen, (E, Fd, D), dtype, 1.0 / math.sqrt(Fd), device),
    }


def _silu(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` step by step in g's dtype: exp, add, reciprocal and
    product each round, as the reference's lowering does (one fused
    rounding would differ by up to two bf16 units)."""
    return g * (1 / (1 + torch.exp(-g)))


def _route(p: Params, cfg: ModelConfig, xf: torch.Tensor
           ) -> Tuple[torch.Tensor, ...]:
    """(logits, probs, topw, topi) of a flat (N, D) block: float32 logits
    and softmax, the k largest probabilities (lower expert first on ties)
    renormalised to sum to one, and their expert ids (N, k) int64."""
    k = cfg.experts_per_token
    logits = (xf @ p["router"]["w"]).float()                   # (N, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :k], topi[:, :k]
    topw = topw / topw.sum(dim=-1, keepdim=True)
    return logits, probs, topw, topi


def _aux(logits: torch.Tensor, probs: torch.Tensor,
         topi: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Switch-style load-balance loss (top-1 assignment share times mean
    router probability) and the router z-loss."""
    E = probs.shape[-1]
    experts = torch.arange(E, device=topi.device)
    me = (topi[:, :1] == experts).float().mean(dim=0)
    ce = probs.mean(dim=0)
    return {"load_balance_loss": E * torch.sum(me * ce),
            "router_z_loss": torch.mean(
                torch.logsumexp(logits, dim=-1) ** 2)}


def _moe_math(p: Params, cfg: ModelConfig, xf: torch.Tensor, *,
              with_aux: bool = True):
    """Dropless routed MLP on a flat (N, D) block: every expert over every
    row, combined in ascending expert order with zero weight for the
    experts a row did not choose."""
    N, D = xf.shape
    E = cfg.num_experts
    logits, probs, topw, topi = _route(p, cfg, xf)
    w = torch.zeros((N, E), dtype=torch.float32, device=xf.device)
    w.scatter_(1, topi, topw)                                  # (N, E)
    xs = xf.unsqueeze(0).expand(E, N, D)
    h = _silu(torch.bmm(xs, p["wg"])) * torch.bmm(xs, p["wi"])  # (E, N, F)
    ys = torch.bmm(h.to(xf.dtype), p["wo"])                    # (E, N, D)
    yw = ys * w.T.to(ys.dtype)[:, :, None]
    out = yw[0]
    for e in range(1, E):
        out = out + yw[e]
    return out, (_aux(logits, probs, topi) if with_aux else None)


# dispatch algorithm for the routed products:
#   "ragged"   — dropless (the reference's ragged_dot; here every expert
#                over every row, see the module docstring)
#   "capacity" — GShard-style fixed-capacity batched products: exactly
#                E x cap rows per weight (cap = 1.25 N k / E); overflow
#                tokens lose that expert's contribution, reported in
#                aux["drop_fraction"]
_DISPATCH = "ragged"


def set_dispatch(mode: str) -> None:
    global _DISPATCH
    assert mode in ("ragged", "capacity")
    _DISPATCH = mode


def _moe_capacity_math(p: Params, cfg: ModelConfig, xf: torch.Tensor, *,
                       capacity_factor: float = 1.25,
                       with_aux: bool = True):
    """Fixed-capacity dispatch: FLOPs bounded at capacity_factor x
    active."""
    N, D = xf.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    logits, probs, topw, topi = _route(p, cfg, xf)

    flat_e = topi.reshape(-1)                                  # (N*k,)
    order = torch.sort(flat_e, stable=True).indices
    token_of = order // k
    idx_s = flat_e[order]
    counts = torch.zeros(E, dtype=torch.int64, device=xf.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    seg_start = torch.cumsum(counts, dim=0) - counts
    rank = torch.arange(N * k, device=xf.device) - seg_start[idx_s]
    cap = max(int(N * k / E * capacity_factor), 1)
    keep = rank < cap
    slot = torch.where(keep, idx_s * cap + rank,
                       torch.full_like(rank, E * cap))         # overflow slot

    xs = xf[token_of]                                          # (N*k, D)
    buf = torch.zeros((E * cap + 1, D), dtype=xf.dtype, device=xf.device)
    buf[slot] = torch.where(keep[:, None], xs, torch.zeros_like(xs))
    xb = buf[:-1].reshape(E, cap, D)
    h = _silu(torch.bmm(xb, p["wg"])) * torch.bmm(xb, p["wi"])
    yb = torch.bmm(h.to(xf.dtype), p["wo"])                    # (E, cap, D)
    y_flat = torch.cat([yb.reshape(E * cap, D),
                        torch.zeros((1, D), dtype=yb.dtype,
                                    device=xf.device)])
    ys = y_flat[slot]                                          # sorted rows

    w_sorted = topw.reshape(-1)[order].to(ys.dtype)
    w_sorted = torch.where(keep, w_sorted, torch.zeros_like(w_sorted))
    out = torch.zeros((N, D), dtype=ys.dtype, device=xf.device)
    out.index_add_(0, token_of, ys * w_sorted[:, None])
    aux = None
    if with_aux:
        aux = _aux(logits, probs, topi)
        aux["drop_fraction"] = 1.0 - keep.float().mean()
    return out, aux


# Set by the launcher or the dry run (``launch.sharding.ShardingOptions
# .moe_shard_map``) to route tokens shard-locally (``_apply_moe_parallel``)
_PARALLEL_MESH = None


def set_parallel_mesh(mesh) -> None:
    """Enable shard-local routing over ``mesh`` (a ``DeviceMesh`` with a
    "model" axis and "data" / ("pod", "data") axes), or disable it with
    None.  Routing is per-token independent, so each data shard routing
    only its own tokens is exact; it spares the global sort and gather
    that would otherwise all-gather the activations."""
    global _PARALLEL_MESH
    _PARALLEL_MESH = mesh


class _SumOverGroup(torch.autograd.Function):
    """Sum of the local partials over a mesh dim's group; the result is
    replicated over the group, so its gradient passes through unchanged
    (every rank holds the whole gradient of a replicated value).  The
    other half of the pair, the sum of the inputs' partial gradients over
    the group, is DTensor's: ``_apply_moe_parallel`` takes its local
    inputs with ``grad_placements`` that are partial over the group."""

    @staticmethod
    def forward(ctx, t, mesh, dim):
        return funcol.wait_tensor(funcol.all_reduce(t, "sum",
                                                    mesh.get_group(dim)))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _MeanOverGroups(torch.autograd.Function):
    """Mean of a local value over the data axes' groups (the reference's
    ``pmean``).  The value is the same on the ``share`` ranks of the model
    group, whose gradients of the inputs are partial sums over that group
    (``grad_placements``): so each rank takes 1/share of the mean's
    gradient, 1/(n share) in all, and the sum over the group restores
    it."""

    @staticmethod
    def forward(ctx, t, mesh, dims, share):
        n = 1
        for d in dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum",
                                                     mesh.get_group(d)))
            n *= mesh.size(mesh.mesh_dim_names.index(d))
        ctx.n = n * share
        return t / n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None, None


def _as_dtensor(t: torch.Tensor, mesh):
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _apply_moe_parallel(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Shard-local MoE, the counterpart of the reference's
    ``_apply_moe_shard_map``: tokens stay on their data shard (local
    routing, local expert products against experts sliced on F over
    "model"), one output sum over the model group, the aux losses averaged
    over the data axes.  Capacity is sized from the local token count, as
    in the reference's shard-local call.  Like the reference, it falls
    back to the plain path when B does not divide over the data axes,
    when F does not divide over "model", or under 64 local tokens (decode:
    the per-layer expert regather does not pay there); the fallback is
    the dropless math under either dispatch, as the reference's.  Inputs
    are DTensors on the mesh or plain tensors (taken as replicated); the
    output is a DTensor sharded on B over the data axes.

    Backward: each model rank's gradients of x and of the router (through
    the combine weights) are its F-slice's share, and each data shard's
    gradients of the weights its tokens' share, so the local inputs carry
    ``grad_placements`` that are partial sums there and DTensor adds the
    shares (Megatron's f to ``_SumOverGroup``'s g)."""
    mesh = _PARALLEL_MESH
    names = tuple(mesh.mesh_dim_names)
    size = dict(zip(names, mesh.shape))
    da = ("pod", "data") if "pod" in names else ("data",)
    n_da = 1
    for a in da:
        n_da *= size[a]
    B, T, D = x.shape
    F = cfg.d_ff
    tokens_local = (B // n_da) * T
    if B % n_da or F % size["model"] or tokens_local < 64:
        if isinstance(x, DTensor):
            return _replicated_moe(p, cfg, x, _moe_math)
        out, aux = _moe_math(p, cfg, x.reshape(B * T, D))
        return out.reshape(B, T, D).to(x.dtype), aux

    math_fn = _moe_capacity_math if _DISPATCH == "capacity" else _moe_math
    rep = [Replicate()] * mesh.ndim
    model = names.index("model")
    partial_data = [Partial() if n in da else Replicate() for n in names]

    def placed(t, dim=None):              # dim: sliced over "model"
        pl, gpl = list(rep), list(partial_data)
        pl[model] = gpl[model] = Shard(dim) if dim is not None else \
            Replicate()
        if dim is None:
            gpl[model] = Partial()
        return _as_dtensor(t, mesh).redistribute(mesh, pl).to_local(
            grad_placements=gpl)

    x_pl = list(rep)
    for a in da:
        x_pl[names.index(a)] = Shard(0)
    x_gpl = list(x_pl)
    x_gpl[model] = Partial()
    xl = _as_dtensor(x, mesh).redistribute(mesh, x_pl).to_local(
        grad_placements=x_gpl)
    pl = {"router": {"w": placed(p["router"]["w"])},
          "wi": placed(p["wi"], 2), "wg": placed(p["wg"], 2),
          "wo": placed(p["wo"], 1)}
    b, t, d = xl.shape
    out, aux = math_fn(pl, cfg, xl.reshape(b * t, d))
    out = _SumOverGroup.apply(out.to(xl.dtype), mesh, "model")
    aux = {k: DTensor.from_local(
        _MeanOverGroups.apply(v, mesh, da, size["model"]), mesh, rep,
        run_check=False) for k, v in aux.items()}
    out = DTensor.from_local(out.reshape(b, t, d), mesh, x_pl,
                             run_check=False)
    return out, aux


def _replicated_moe(p: Params, cfg: ModelConfig, x, math_fn):
    """The plain path on DTensors: every input gathered whole, the routed
    products computed redundantly on each rank (what a partitioner does
    with a global sort it cannot split), the output replicated."""
    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim

    def whole(t):
        return _as_dtensor(t, mesh).redistribute(mesh, rep).to_local()

    B, T, D = x.shape
    pl = {"router": {"w": whole(p["router"]["w"])}, "wi": whole(p["wi"]),
          "wg": whole(p["wg"]), "wo": whole(p["wo"])}
    out, aux = math_fn(pl, cfg, whole(x).reshape(B * T, D))
    out = DTensor.from_local(out.reshape(B, T, D).to(x.dtype), mesh, rep,
                             run_check=False)
    aux = {k: DTensor.from_local(v, mesh, rep, run_check=False)
           for k, v in aux.items()}
    return out, aux


def apply_moe(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              return_aux: bool = False):
    """x: (B, T, D) -> (B, T, D) [, aux losses dict]."""
    B, T, D = x.shape
    math_fn = _moe_capacity_math if _DISPATCH == "capacity" else _moe_math
    if _PARALLEL_MESH is not None:
        out, aux = _apply_moe_parallel(p, cfg, x)
    elif isinstance(x, DTensor):
        out, aux = _replicated_moe(p, cfg, x, math_fn)
    else:
        out, aux = math_fn(p, cfg, x.reshape(B * T, D), with_aux=return_aux)
        out = out.reshape(B, T, D).to(x.dtype)
    if return_aux:
        return out, aux
    return out
