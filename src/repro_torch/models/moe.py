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
A DTensor input with no mesh set takes the same split on its own mesh,
dropless, with the aux losses of all rows (the reference leaves its
plain path to GSPMD, which splits it).  Decode's few tokens, in either
case, move to the experts where they are stored instead
(``_moving_tokens``).  No device runs rows it does not own through
experts it does not hold (``_moe_on_mesh``).  It runs on DTensors (or on
plain tensors, taken as replicated) through explicit collectives on the
mesh's groups.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

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


def _aux(logits: torch.Tensor, probs: torch.Tensor, topi: torch.Tensor,
         mean=None) -> Dict[str, torch.Tensor]:
    """Switch-style load-balance loss (top-1 assignment share times mean
    router probability) and the router z-loss.  ``mean`` turns a mean
    over this block's rows into one over all rows (a block that is one
    shard of them); the default takes the block as all."""
    mean = mean or (lambda t: t)
    E = probs.shape[-1]
    experts = torch.arange(E, device=topi.device)
    me = mean((topi[:, :1] == experts).float().mean(dim=0))
    ce = mean(probs.mean(dim=0))
    return {"load_balance_loss": E * torch.sum(me * ce),
            "router_z_loss": mean(torch.mean(
                torch.logsumexp(logits, dim=-1) ** 2))}


def _combine_weights(topw: torch.Tensor, topi: torch.Tensor,
                     E: int) -> torch.Tensor:
    """(N, E) float32: each row's renormalised weight of the experts it
    chose, zero for the others."""
    w = torch.zeros((topw.shape[0], E), dtype=torch.float32,
                    device=topw.device)
    return w.scatter_(1, topi, topw)


def _combine(ys: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_e ys[e] * w[:, e] over (E, N, D) expert outputs, in ascending
    expert order, in ys's dtype."""
    yw = ys * w.T.to(ys.dtype)[:, :, None]
    out = yw[0]
    for e in range(1, yw.shape[0]):
        out = out + yw[e]
    return out


def _moe_math(p: Params, cfg: ModelConfig, xf: torch.Tensor, *,
              with_aux: bool = True, first_expert: int = 0, aux_mean=None):
    """Dropless routed MLP on a flat (N, D) block: every expert over every
    row, combined in ascending expert order with zero weight for the
    experts a row did not choose.  ``p`` may hold a slice of the experts
    (``wi`` etc. of E_l < E, from ``first_expert``): the rows are routed
    over all E, and only the slice's part of the sum is returned.
    ``aux_mean``: ``_aux``'s ``mean``."""
    N, D = xf.shape
    El = p["wi"].shape[0]
    logits, probs, topw, topi = _route(p, cfg, xf)
    w = _combine_weights(topw, topi, cfg.num_experts)
    xs = xf.unsqueeze(0).expand(El, N, D)
    h = _silu(torch.bmm(xs, p["wg"])) * torch.bmm(xs, p["wi"])  # (E, N, F)
    ys = torch.bmm(h.to(xf.dtype), p["wo"])                    # (E, N, D)
    out = _combine(ys, w[:, first_expert:first_expert + El])
    return out, (_aux(logits, probs, topi, aux_mean) if with_aux else None)


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


def runs_capacity(cfg: ModelConfig, B: int, T: int) -> bool:
    """Whether ``apply_moe`` runs the capacity math on a (B, T) input
    under the module's dispatch and parallel mesh: with no parallel mesh
    on a plain tensor (a DTensor is refused), and with one only where the
    shard-local path slices the experts on F; its other paths are
    dropless, as the reference's fallback is."""
    if _DISPATCH != "capacity":
        return False
    return _PARALLEL_MESH is None or shard_local_split(
        cfg, _PARALLEL_MESH, B, T) == "F"


def _apply_moe_parallel(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Shard-local MoE over the parallel mesh, the counterpart of the
    reference's ``_apply_moe_shard_map``: ``_moe_on_mesh`` under the
    module's dispatch."""
    B, T, _ = x.shape
    return _moe_on_mesh(p, cfg, x, _PARALLEL_MESH,
                        capacity=runs_capacity(cfg, B, T))


def _moe_on_mesh(p: Params, cfg: ModelConfig, x: torch.Tensor, mesh, *,
                 capacity: bool = False, global_aux: bool = False):
    """The MoE with no device running rows it does not own through
    experts it does not hold.  Inputs are DTensors on ``mesh`` or plain
    tensors (taken as replicated).

    Where B divides over the data axes and a data shard has 64 tokens or
    more (``_shard_local``): tokens stay on their data shard (local
    routing, local expert products against the experts sliced on F over
    "model", or on E where only E divides it), one output sum over the
    model group; the output is a DTensor sharded on B over the data axes.
    Capacity (``capacity``, sized from the local token count as in the
    reference's shard-local call) needs F to divide "model", as the
    reference's does (``runs_capacity``).  The aux losses are
    the mean of each data shard's, as under the reference's shard_map,
    or, with ``global_aux``, those of all rows, as the reference's plain
    path gives them.

    Else (``_moving_tokens``: decode, rows that do not divide, or experts
    that divide "model" on neither F nor E) the dropless math runs with
    the weights left where they are stored, and the few tokens move to
    them.  The reference keeps its plain path here (shard_map's per-layer
    regather of the experts over the data axes measured 1.8x slower at
    decode), so gathering the experts is what this path avoids; each
    product splits its work as ``_local_bmm`` says."""
    B, T, _ = x.shape
    split = shard_local_split(cfg, mesh, B, T)
    if split is None:
        return _moving_tokens(p, cfg, x, mesh)
    names = tuple(mesh.mesh_dim_names)
    da = ("pod", "data") if "pod" in names else ("data",)
    if capacity:
        return _shard_local(p, cfg, x, mesh, da, split, _moe_capacity_math)
    return _shard_local(p, cfg, x, mesh, da, split, _moe_math,
                        global_aux=global_aux)


def shard_local_split(cfg: ModelConfig, mesh, B: int,
                      T: int) -> Optional[str]:
    """How ``_moe_on_mesh`` slices the experts over "model" for a (B, T)
    input that takes the shard-local path: "F", or "E" where only the
    experts divide; None where the input takes ``_moving_tokens``."""
    names = tuple(mesh.mesh_dim_names or ())
    da = ("pod", "data") if "pod" in names else ("data",)
    if "model" not in names or any(a not in names for a in da):
        return None
    size = dict(zip(names, mesh.shape))
    n_da = math.prod(size[a] for a in da)
    if B % n_da or (B // n_da) * T < 64:
        return None
    n_m = size["model"]
    return ("F" if cfg.d_ff % n_m == 0 else
            "E" if cfg.num_experts % n_m == 0 else None)


def _shard_local(p: Params, cfg: ModelConfig, x, mesh, da, split: str,
                 math_fn, global_aux: bool = False):
    """Each data shard's rows through each model rank's slice of the
    experts (``split`` "F": wi / wg on F, wo on its F rows; "E": whole
    experts, E / n each), one sum over the model group.  The aux losses
    are the mean of each shard's, as the reference's shard_map takes
    them, or with ``global_aux`` the losses of all rows (each mean over
    the rows averaged over the shards before the load-balance product),
    as the reference's plain path computes them on global arrays.

    Backward: each model rank's gradients of x and of the router (through
    the combine weights) are its slice's share, and each data shard's
    gradients of the weights its tokens' share, so the local inputs carry
    ``grad_placements`` that are partial sums there and DTensor adds the
    shares (Megatron's f to ``_SumOverGroup``'s g)."""
    names = tuple(mesh.mesh_dim_names)
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
    dims = (2, 2, 1) if split == "F" else (0, 0, 0)
    pl = {"router": {"w": placed(p["router"]["w"])},
          "wi": placed(p["wi"], dims[0]), "wg": placed(p["wg"], dims[1]),
          "wo": placed(p["wo"], dims[2])}
    extra = {}
    if global_aux:
        extra["aux_mean"] = lambda t: _MeanOverGroups.apply(
            t, mesh, da, mesh.size(model))
    if split == "E":
        extra["first_expert"] = mesh.get_local_rank(model) * \
            pl["wi"].shape[0]
    b, t, d = xl.shape
    out, aux = math_fn(pl, cfg, xl.reshape(b * t, d), **extra)
    out = _SumOverGroup.apply(out.to(xl.dtype), mesh, "model")
    if not global_aux:
        aux = {k: _MeanOverGroups.apply(v, mesh, da, mesh.size(model))
               for k, v in aux.items()}
    aux = {k: DTensor.from_local(v, mesh, rep, run_check=False)
           for k, v in aux.items()}
    out = DTensor.from_local(out.reshape(b, t, d), mesh, x_pl,
                             run_check=False)
    return out, aux


def _local_bmm(a: DTensor, w: DTensor) -> DTensor:
    """a @ w, shard by shard, for an (E, N, K) activation and an (E, K, M)
    weight, the weight's shards left where they lie.  On each mesh dim
    the activation follows the weight: its shard of E, or of K (the
    product is then a partial sum), or whole where the weight's M is
    sharded.  Where the weight is whole, it is sliced locally to match
    the activation's shard of E or K; else the activation takes a share
    of the rows where they divide, else the weight is sliced locally on
    M, K or E, the first that divides.  A local slice is taken only
    where no later mesh dim shards the same weight dim (DTensor nests a
    later dim's shards inside an earlier's, so the slice would move the
    weight).  Where nothing divides, the ranks repeat the product.
    Returns the (E, N, M) product as a DTensor."""
    mesh = a.device_mesh
    stored = list(w.placements)

    def left(t, dim, pl):
        n = t.shape[dim]
        for i, p in enumerate(pl):
            if p == Shard(dim):
                n //= mesh.size(i)
        return n

    def clean(i, dim):                 # a local slice of w's dim on i
        return all(p != Shard(dim) for p in stored[i + 1:])

    n_left = a.shape[1]                        # rows left to split
    for i, (ap, wp) in enumerate(zip(a.placements, stored)):
        if ap == Shard(1) and wp.is_replicate():
            n_left //= mesh.size(i)
    free = {2: left(w, 2, stored), 1: left(w, 1, stored),
            0: left(w, 0, stored)}             # M, K and E left to slice
    apl, agpl, wpl, wgpl, opl = [], [], [], [], []
    for i, (ap, wp) in enumerate(zip(a.placements, stored)):
        n = mesh.size(i)
        if wp.is_replicate() and ap != Shard(1):
            follow = {Shard(0): 0, Shard(2): 1}.get(ap)
            if follow is not None and clean(i, follow):
                wp = Shard(follow)
            elif n_left % n == 0:
                ap, n_left = Shard(1), n_left // n
            else:
                for dim in (2, 1, 0):
                    if free[dim] % n == 0 and clean(i, dim):
                        wp, free[dim] = Shard(dim), free[dim] // n
                        break
        if wp == Shard(0):
            row = (Shard(0), Shard(0), Shard(0), Shard(0), Shard(0))
        elif wp == Shard(1):
            row = (Shard(2), Shard(2), Shard(1), Shard(1), Partial())
        elif wp == Shard(2):
            row = (Replicate(), Partial(), Shard(2), Shard(2), Shard(2))
        elif ap == Shard(1):
            row = (Shard(1), Shard(1), Replicate(), Partial(), Shard(1))
        else:                                   # both whole: repeated
            row = (Replicate(),) * 5
        for lst, v in zip((apl, agpl, wpl, wgpl, opl), row):
            lst.append(v)
    al = a.redistribute(mesh, apl).to_local(grad_placements=agpl)
    wl = w.redistribute(mesh, wpl).to_local(grad_placements=wgpl)
    return DTensor.from_local(torch.bmm(al, wl), mesh, opl, run_check=False)


def _summed(placements) -> list:
    """``placements`` with each partial sum completed (shards kept)."""
    return [Replicate() if p.is_partial() else p for p in placements]


def _whole(t: DTensor) -> DTensor:
    """t with each partial sum completed (shards kept)."""
    pl = _summed(t.placements)
    return t.redistribute(t.device_mesh, pl) if pl != list(t.placements) \
        else t


def _moving_tokens(p: Params, cfg: ModelConfig, x, mesh):
    """The dropless math with every row on every rank and each expert
    weight where it is stored (``_moe_on_mesh``).  The rows are gathered
    (decode: B x D), routed on every rank (N x D x E products: 256 / 3F
    of a rank's share of the experts' on 256 ranks, 0.5% for Mixtral),
    and sent through
    the experts by ``_local_bmm``: under the plain rule's (E, D / data,
    F / model) wi / wg each rank takes its D slice of every row and its F
    slice of the outputs (a partial sum over the data axes, completed by
    an all-reduce of E x N x F / model), and h moves to wo's (E, F / data,
    D / model) shards.  The combine follows the products' shards and
    one redistribution completes the output in x's placements (plain x:
    a plain output).  The routing's gradient is whole on every rank: the
    combine weights' shares are summed back over the ranks."""
    B, T, D = x.shape
    N, E = B * T, cfg.num_experts
    rep = [Replicate()] * mesh.ndim
    xw = _as_dtensor(x, mesh).redistribute(mesh, rep)
    router = _as_dtensor(p["router"]["w"], mesh).redistribute(mesh, rep)
    logits, probs, topw, topi = _route(
        {"router": {"w": router.to_local()}}, cfg,
        xw.to_local().reshape(N, D))
    w = _combine_weights(topw, topi, E)
    xs = xw.reshape(N, D).unsqueeze(0).expand(E, N, D)
    g = _whole(_local_bmm(xs, _as_dtensor(p["wg"], mesh)))
    i = _whole(_local_bmm(xs, _as_dtensor(p["wi"], mesh)))
    if list(i.placements) != list(g.placements):
        i = i.redistribute(mesh, g.placements)
    h = DTensor.from_local(
        (_silu(g.to_local()) * i.to_local()).to(x.dtype), mesh,
        g.placements, run_check=False)
    y = _local_bmm(h, _as_dtensor(p["wo"], mesh))              # (E, N, D)
    # the combine weights on y's shards of E and of the rows; summed back
    # over the ranks where y holds a partial sum or a slice of D
    wpl, wgpl, opl = [], [], []
    for yp in y.placements:
        if yp == Shard(0):
            row = (Shard(1), Shard(1), Partial())
        elif yp == Shard(1):
            row = (Shard(0), Shard(0), Shard(0))
        elif yp == Shard(2):
            row = (Replicate(), Partial(), Shard(1))
        elif yp.is_partial():
            row = (Replicate(), Partial(), Partial())
        else:
            row = (Replicate(), Replicate(), Replicate())
        for lst, v in zip((wpl, wgpl, opl), row):
            lst.append(v)
    wl = DTensor.from_local(w, mesh, rep, run_check=False).redistribute(
        mesh, wpl).to_local(grad_placements=wgpl)
    out = DTensor.from_local(_combine(y.to_local(), wl), mesh, opl,
                             run_check=False)
    out = out.redistribute(mesh, rep).reshape(B, T, D)
    aux = _aux(logits, probs, topi)
    if not isinstance(x, DTensor):
        return out.to_local(), aux
    aux = {k: DTensor.from_local(v, mesh, rep, run_check=False)
           for k, v in aux.items()}
    return out.redistribute(mesh, _summed(x.placements)), aux


def apply_moe(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
              return_aux: bool = False):
    """x: (B, T, D) -> (B, T, D) [, aux losses dict].  With a parallel
    mesh set, ``_apply_moe_parallel``; a DTensor input without one runs
    ``_moe_on_mesh`` on its own mesh, dropless.  The capacity dispatch
    of a DTensor input needs the parallel mesh (no preset runs it without
    one): its global sort over all rows has no split form that keeps the
    result, and the dropless math would not drop what the reference's
    plain path drops."""
    B, T, D = x.shape
    if _PARALLEL_MESH is not None:
        out, aux = _apply_moe_parallel(p, cfg, x)
    elif isinstance(x, DTensor):
        if _DISPATCH == "capacity":
            raise ValueError("the capacity dispatch of a DTensor input "
                             "needs the parallel mesh (set_parallel_mesh, "
                             "ShardingOptions.moe_shard_map)")
        out, aux = _moe_on_mesh(p, cfg, x, x.device_mesh, global_aux=True)
    else:
        math_fn = _moe_capacity_math if runs_capacity(cfg, B, T) \
            else _moe_math
        out, aux = math_fn(p, cfg, x.reshape(B * T, D), with_aux=return_aux)
        out = out.reshape(B, T, D).to(x.dtype)
    if return_aux:
        return out, aux
    return out
