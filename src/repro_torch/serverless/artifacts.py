"""LLM artifact taxonomy for pre-loading/offloading (paper §4.1; port of
``repro/serverless/artifacts.py``, pure host code).

Four artifact kinds with loading precedence LIBRARY → MODEL → KERNEL
(CUDA-kernel JIT in the paper; in this port the KERNEL artifact is the
loaded kernel library plus a function's captured decode graphs — same
role: must exist before first inference, expensive to produce, cheap to
keep).  Adapters couple to their backbone's GPU.

Each artifact records byte size, where it may reside (container / GPU), and
its load latency per source tier.  ``value`` = load-latency-saved × request
rate — the v_i^f of the paper's knapsack objective.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional


class Kind(enum.Enum):
    LIBRARY = "library"      # python/ML libs: container memory only
    BACKBONE = "backbone"    # shared LLM weights: container or GPU
    ADAPTER = "adapter"      # LoRA weights: container or GPU
    KERNEL = "kernel"        # compiled program (kernels, graphs): GPU only


class Tier(enum.Enum):
    REMOTE = "remote"        # object storage
    HOST = "host"            # container / node DRAM
    GPU = "gpu"              # accelerator HBM


# precedence graph (paper: "models require libraries first, kernels require
# models on GPU first")
PRECEDENCE: Dict[Kind, Optional[Kind]] = {
    Kind.LIBRARY: None,
    Kind.BACKBONE: Kind.LIBRARY,
    Kind.ADAPTER: Kind.BACKBONE,
    Kind.KERNEL: Kind.BACKBONE,
}


@dataclasses.dataclass(frozen=True)
class Artifact:
    fn_id: str               # owning function ("" → shared, e.g. backbone)
    kind: Kind
    name: str
    nbytes: int
    load_remote_s: float     # remote → host
    load_host_s: float       # host → GPU (or init cost for libs/kernels)

    @property
    def key(self):
        return (self.fn_id, self.kind, self.name)

    def gpu_eligible(self) -> bool:
        return self.kind in (Kind.BACKBONE, Kind.ADAPTER, Kind.KERNEL)

    def host_eligible(self) -> bool:
        return self.kind in (Kind.LIBRARY, Kind.BACKBONE, Kind.ADAPTER)

    def latency_saved(self, tier: Tier) -> float:
        """Cold-start seconds avoided when pre-resident at ``tier``."""
        full = self.load_remote_s + self.load_host_s
        if tier == Tier.GPU:
            return full
        if tier == Tier.HOST:
            return self.load_remote_s
        return 0.0

    def value(self, tier: Tier, request_rate: float) -> float:
        """v_i^f — expected cold-start seconds saved per unit time."""
        return self.latency_saved(tier) * request_rate

    def density(self, tier: Tier, request_rate: float) -> float:
        """ρ = v / w — the greedy key of the paper's PCKP heuristic."""
        return self.value(tier, request_rate) / max(self.nbytes, 1)
