"""Pre-Loading Scheduler — Precedence-Constrained Knapsack (paper §4.1;
port of ``repro/serverless/preload.py``).

Objective (Eq. 1): maximize Σ_f Σ_i v_i^f x_i over container and GPU
placements, subject to capacity, precedence (LIBRARY → BACKBONE → KERNEL /
ADAPTER), and backbone-adapter GPU coupling.

Two solvers:
  * ``greedy_preload`` — the paper's production path: sort by value density
    ρ = v/w, place greedily while constraints hold.  O(|A| log |A| ·
    (|C|+|G|)).
  * ``exact_preload`` — exponential DP/branch-and-bound oracle for small
    instances; used in tests to bound the greedy's optimality gap.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serverless.artifacts import Artifact, Kind, Tier
from repro_torch.serverless.cluster import Cluster


@dataclasses.dataclass(frozen=True)
class Placement:
    artifact: Artifact
    tier: Tier
    location: str            # container_id or gpu_id
    value: float


@dataclasses.dataclass
class FunctionSpec:
    """Scheduler-side view of a serverless function."""
    fn_id: str
    backbone_id: str
    artifacts: List[Artifact]
    request_rate: float      # req/s estimate (arrival frequency analysis)

    def by_kind(self, kind: Kind) -> List[Artifact]:
        return [a for a in self.artifacts if a.kind == kind]


def _candidates(functions: Sequence[FunctionSpec], cluster: Cluster,
                share_backbone: bool):
    """All (artifact, tier, location, density) candidates."""
    out = []
    seen_backbones = set()
    for f in functions:
        for a in f.artifacts:
            if share_backbone and a.kind == Kind.BACKBONE:
                # one shared candidate per backbone id, valued at the SUM of
                # sharing functions' rates (the redundancy elimination)
                if a.name in seen_backbones:
                    continue
                seen_backbones.add(a.name)
                rate = sum(g.request_rate for g in functions
                           if g.backbone_id == a.name)
            else:
                rate = f.request_rate
            if a.gpu_eligible():
                for g in cluster.gpus:
                    out.append((a, Tier.GPU, g.gpu_id, a.value(Tier.GPU, rate),
                                a.density(Tier.GPU, rate)))
            if a.host_eligible():
                for c in cluster.containers:
                    out.append((a, Tier.HOST, c.container_id,
                                a.value(Tier.HOST, rate),
                                a.density(Tier.HOST, rate)))
    return out


def _precedence_ok(art: Artifact, tier: Tier, loc: str, cluster: Cluster,
                   placed: Dict, share_backbone: bool,
                   fn_backbone: Optional[Dict[str, str]] = None) -> bool:
    """Check the paper's assignment/precedence/coupling constraints against
    both current residency and tentative placements."""
    def is_own_backbone(key) -> bool:
        if key[1] != Kind.BACKBONE:
            return False
        if fn_backbone is None or art.fn_id not in fn_backbone:
            return share_backbone or key[0] in ("", art.fn_id)
        bb = fn_backbone[art.fn_id]
        return key[2] == bb or key[2] == f"{bb}@{art.fn_id}"

    def backbone_on_gpu(gpu_id: str) -> bool:
        for (key, (t, l)) in placed.items():
            if t == Tier.GPU and l == gpu_id and is_own_backbone(key):
                return True
        g = cluster.gpu(gpu_id)
        return any(is_own_backbone(k) for k in g.resident)

    def backbone_on_any_gpu() -> bool:
        return any(backbone_on_gpu(g.gpu_id) for g in cluster.gpus)

    if art.kind == Kind.LIBRARY:
        if tier != Tier.HOST:
            return False
        # locality: co-place with the function's backbone GPU when one exists
        if backbone_on_any_gpu():
            return backbone_on_gpu(cluster.container(loc).gpu_id)
        return True
    if art.kind == Kind.BACKBONE:
        return True  # model may pre-stage in host or GPU
    if art.kind == Kind.KERNEL:
        return tier == Tier.GPU and backbone_on_gpu(loc)
    if art.kind == Kind.ADAPTER:
        if tier == Tier.GPU:
            return backbone_on_gpu(loc)
        # host adapter must sit in a container attached to the backbone's GPU
        c = cluster.container(loc)
        return backbone_on_gpu(c.gpu_id)
    return False


def greedy_preload(functions: Sequence[FunctionSpec], cluster: Cluster, *,
                   share_backbone: bool = True) -> List[Placement]:
    """Paper's greedy: descending value density, respecting constraints.

    Only fills *existing idle* capacity (principle 1 of §4.1: never create
    instances just to pre-load). Returns the placement list; caller applies
    it (the Pre-Loading Agent)."""
    cands = _candidates(functions, cluster, share_backbone)
    cands.sort(key=lambda t: -t[4])
    fn_backbone = {f.fn_id: f.backbone_id for f in functions}
    free_gpu = {g.gpu_id: g.free for g in cluster.gpus}
    free_host = {c.container_id: c.free for c in cluster.containers}
    placed: Dict[Tuple, Tuple[Tier, str]] = {}
    out: List[Placement] = []
    # Multi-pass to a fixpoint: a high-density artifact (kernel/adapter) can
    # be blocked only because its backbone hasn't been placed yet this pass.
    progress = True
    while progress:
        progress = False
        for art, tier, loc, value, dens in cands:
            if value <= 0:
                continue
            if art.key in placed:            # already placed at a better tier
                prev_tier, _ = placed[art.key]
                if prev_tier == Tier.GPU or prev_tier == tier:
                    continue
                if tier == Tier.HOST:
                    continue
            if tier == Tier.GPU:
                if cluster.find_gpu_with(art.key) is not None:
                    continue      # already resident on some GPU — no replicas
                if free_gpu[loc] < art.nbytes:
                    continue
            else:
                if cluster.find_host_with(art.key) is not None \
                        or cluster.find_gpu_with(art.key) is not None:
                    continue      # resident in host or at a better tier
                if free_host[loc] < art.nbytes:
                    continue
            if not _precedence_ok(art, tier, loc, cluster, placed,
                                  share_backbone, fn_backbone):
                continue
            if tier == Tier.GPU:
                free_gpu[loc] -= art.nbytes
            else:
                free_host[loc] -= art.nbytes
            if art.key in placed and tier == Tier.GPU:
                # HOST→GPU upgrade keeps both copies, but only the
                # *incremental* latency saving counts toward the objective
                prev = next(p for p in out if p.artifact.key == art.key)
                value = max(value - prev.value, 0.0)
            placed[art.key] = (tier, loc)
            out.append(Placement(art, tier, loc, value))
            progress = True
    return out


def plan_value(plan: Sequence[Placement]) -> float:
    return sum(p.value for p in plan)


def exact_preload(functions: Sequence[FunctionSpec], cluster: Cluster, *,
                  share_backbone: bool = True,
                  max_states: int = 2_000_000) -> List[Placement]:
    """Brute-force oracle (tests only): enumerate all feasible assignment
    combinations of (artifact → tier/location or skip). Exponential."""
    cands = _candidates(functions, cluster, share_backbone)
    # group candidate slots per artifact key
    arts: Dict[Tuple, List] = {}
    for a, tier, loc, value, dens in cands:
        arts.setdefault(a.key, []).append((a, tier, loc, value))
    keys = list(arts)
    options = [[None] + arts[k] for k in keys]
    n_states = 1
    for o in options:
        n_states *= len(o)
    if n_states > max_states:
        raise ValueError(f"instance too large for exact solver: {n_states}")

    fn_backbone = {f.fn_id: f.backbone_id for f in functions}
    best_val, best_plan = -1.0, []
    for combo in itertools.product(*options):
        free_gpu = {g.gpu_id: g.free for g in cluster.gpus}
        free_host = {c.container_id: c.free for c in cluster.containers}
        placed, plan, val, ok = {}, [], 0.0, True
        # place BACKBONE first, then KERNEL/ADAPTER, then LIBRARY (locality)
        order_of = {Kind.BACKBONE: 0, Kind.KERNEL: 1, Kind.ADAPTER: 1,
                    Kind.LIBRARY: 2}
        ordered = sorted((c for c in combo if c is not None),
                         key=lambda c: order_of[c[0].kind])
        for a, tier, loc, value in ordered:
            cap = free_gpu if tier == Tier.GPU else free_host
            if cap[loc] < a.nbytes or not _precedence_ok(
                    a, tier, loc, cluster, placed, share_backbone,
                    fn_backbone):
                ok = False
                break
            cap[loc] -= a.nbytes
            placed[a.key] = (tier, loc)
            plan.append(Placement(a, tier, loc, value))
            val += value
        if ok and val > best_val:
            best_val, best_plan = val, plan
    return best_plan
