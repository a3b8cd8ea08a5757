"""Dynamic GPU Offloader (paper §4.3; port of ``repro/serverless/offload.py``:
bookkeeping on the cluster model, no device copy).

When an arriving batch needs Q bytes of KV-cache memory on GPU g, free at
least Q (Eq. 6) while minimizing the pre-loading value destroyed (Eq. 7).
Same greedy value-density heuristic as the pre-loader, ascending this time:
evict the least valuable artifact per byte first. Models move down to
container memory (still warm-ish); kernels are dropped (re-JIT on demand).
Artifacts pinned by running functions are never evicted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serverless.artifacts import Artifact, Kind, Tier
from repro_torch.serverless.cluster import Cluster, GPU


@dataclasses.dataclass(frozen=True)
class Eviction:
    artifact: Artifact
    gpu_id: str
    dest: Optional[str]       # container_id (demote) or None (drop)
    value_lost: float


def plan_offload(gpu: GPU, need_bytes: int, cluster: Cluster,
                 rates: Dict[str, float]) -> Optional[List[Eviction]]:
    """Choose evictions freeing ≥ need_bytes. Returns None if impossible
    (everything pinned)."""
    if gpu.free >= need_bytes:
        return []
    cands: List[Tuple[float, Artifact]] = []
    for key, art in gpu.resident.items():
        if key in gpu.pinned:
            continue
        rate = rates.get(art.fn_id, sum(rates.values()) if art.fn_id == ""
                         else 0.0)
        # value lost if evicted from GPU = GPU-tier value (it may partially
        # survive in host: then only the host→gpu part is lost)
        cands.append((art.density(Tier.GPU, rate), art))
    cands.sort(key=lambda t: t[0])

    freed, plan = gpu.free, []
    for dens, art in cands:
        if freed >= need_bytes:
            break
        dest = None
        if art.kind in (Kind.BACKBONE, Kind.ADAPTER):
            for c in cluster.containers_of_gpu(gpu.gpu_id):
                if c.free >= art.nbytes:
                    dest = c.container_id
                    break
        rate = rates.get(art.fn_id, 0.0)
        plan.append(Eviction(art, gpu.gpu_id, dest,
                             art.value(Tier.GPU, rate)))
        freed += art.nbytes
    if freed < need_bytes:
        return None
    return plan


def apply_offload(plan: List[Eviction], cluster: Cluster) -> int:
    """Execute the eviction plan. Returns bytes freed."""
    freed = 0
    for ev in plan:
        g = cluster.gpu(ev.gpu_id)
        art = g.remove(ev.artifact.key)
        if art is None:
            continue
        freed += art.nbytes
        if ev.dest is not None:
            c = cluster.container(ev.dest)
            if c.free >= art.nbytes and not c.holds(art.key):
                c.add(art)
    return freed
