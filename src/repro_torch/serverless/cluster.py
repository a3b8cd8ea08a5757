"""Cluster state: worker nodes with GPUs (HBM) and containers (host mem)
(port of ``repro/serverless/cluster.py``).

Pure bookkeeping — memory accounting, artifact residency, refcounts — used
by the Pre-Loading Scheduler, Dynamic Offloader, and the simulator. A GPU
tracks concurrently running batches (M of paper Eq. 4) for contention.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.serverless.artifacts import Artifact


@dataclasses.dataclass
class GPU:
    gpu_id: str
    hbm_bytes: int
    resident: Dict[Tuple, Artifact] = dataclasses.field(default_factory=dict)
    pinned: Set[Tuple] = dataclasses.field(default_factory=set)  # in active use
    active_batches: int = 0          # M — concurrent batches (contention)
    kv_reserved: int = 0             # bytes reserved for running KV caches

    @property
    def used(self) -> int:
        return sum(a.nbytes for a in self.resident.values()) + self.kv_reserved

    @property
    def free(self) -> int:
        return self.hbm_bytes - self.used

    def holds(self, key) -> bool:
        return key in self.resident

    def add(self, art: Artifact) -> None:
        if art.nbytes > self.free:
            raise MemoryError(f"GPU {self.gpu_id}: {art.name} needs "
                              f"{art.nbytes}, free {self.free}")
        self.resident[art.key] = art

    def remove(self, key) -> Optional[Artifact]:
        return self.resident.pop(key, None)


@dataclasses.dataclass
class Container:
    container_id: str
    node_id: str
    gpu_id: str                      # attached accelerator
    host_bytes: int
    resident: Dict[Tuple, Artifact] = dataclasses.field(default_factory=dict)
    warm: bool = False               # container process started
    busy_until: float = 0.0

    @property
    def used(self) -> int:
        return sum(a.nbytes for a in self.resident.values())

    @property
    def free(self) -> int:
        return self.host_bytes - self.used

    def holds(self, key) -> bool:
        return key in self.resident

    def add(self, art: Artifact) -> None:
        if art.nbytes > self.free:
            raise MemoryError(f"container {self.container_id}: {art.name}")
        self.resident[art.key] = art

    def remove(self, key) -> Optional[Artifact]:
        return self.resident.pop(key, None)


@dataclasses.dataclass
class Node:
    node_id: str
    gpus: List[GPU]
    containers: List[Container]


class Cluster:
    def __init__(self, num_nodes: int, gpus_per_node: int,
                 containers_per_gpu: int, hbm_bytes: int, host_bytes: int):
        self.nodes: List[Node] = []
        for n in range(num_nodes):
            gpus = [GPU(f"n{n}g{g}", hbm_bytes) for g in range(gpus_per_node)]
            containers = [
                Container(f"n{n}g{g}c{c}", f"n{n}", f"n{n}g{g}", host_bytes)
                for g in range(gpus_per_node) for c in range(containers_per_gpu)
            ]
            self.nodes.append(Node(f"n{n}", gpus, containers))
        self._gpu_index = {g.gpu_id: g for node in self.nodes
                           for g in node.gpus}
        self._ct_index = {c.container_id: c for node in self.nodes
                          for c in node.containers}

    # ------------------------------------------------------------- lookups
    def gpu(self, gpu_id: str) -> GPU:
        return self._gpu_index[gpu_id]

    def container(self, cid: str) -> Container:
        return self._ct_index[cid]

    @property
    def gpus(self) -> List[GPU]:
        return list(self._gpu_index.values())

    @property
    def containers(self) -> List[Container]:
        return list(self._ct_index.values())

    def containers_of_gpu(self, gpu_id: str) -> List[Container]:
        return [c for c in self._ct_index.values() if c.gpu_id == gpu_id]

    # ---------------------------------------------------------- residency
    def find_gpu_with(self, key) -> Optional[GPU]:
        for g in self._gpu_index.values():
            if g.holds(key):
                return g
        return None

    def find_host_with(self, key) -> Optional[Container]:
        for c in self._ct_index.values():
            if c.holds(key):
                return c
        return None

    def total_gpu_bytes_used(self) -> int:
        return sum(g.used for g in self._gpu_index.values())
