"""Serving policies: ServerlessLoRA, its ablation variants, and the four
baselines the paper compares against (§6.1; port of
``repro/serverless/baselines.py``).

A policy is a declarative description of which mechanisms are active; the
simulator interprets it.  Baselines are faithful to the papers' published
behaviour at the granularity our latency model resolves:

* ServerlessLLM [OSDI'24] — fast checkpoint path (local cache + loading-
  optimized format → the remote leg disappears, H2D at full bandwidth) but
  no library/kernel pre-load, no sharing, fixed small batches.
* InstaInfer [SoCC'24] — opportunistically pre-loads libraries + model +
  adapter into *container* memory (not GPU), misses kernels; designed for
  small models, so every invocation still pays H2D of the full backbone.
* vLLM [SOSP'23] — serverful: one long-running replica per function
  (no LoRA multiplexing), zero cold start, pays wall-clock GPU time.
* dLoRA [OSDI'24] — serverful multi-LoRA: one replica per *backbone*
  (cross-adapter batching), zero cold start, fewer GPUs than vLLM.
"""
from __future__ import annotations

import dataclasses
from typing import FrozenSet

from repro_torch.serverless.artifacts import Kind


@dataclasses.dataclass(frozen=True)
class Policy:
    name: str
    share_backbone: bool = False
    preload_kinds: FrozenSet[Kind] = frozenset()
    preload_to_gpu: bool = False       # else container memory only
    fast_checkpoint: bool = False      # skip the remote leg of model loads
    adaptive_batching: bool = True
    fixed_batch: int = 1
    fixed_delay: float = 0.0
    dynamic_offload: bool = False
    serverful: bool = False
    keepalive_s: float = 120.0
    # max concurrently executing batches per accelerator: beyond this the
    # batch queues (fill-or-expire keeps collecting) instead of timeslicing
    # an already-saturated chip (Eq. 4 contention applies below the cap)
    max_concurrency: int = 2


SERVERLESS_LORA = Policy(
    name="ServerlessLoRA", share_backbone=True,
    preload_kinds=frozenset({Kind.LIBRARY, Kind.BACKBONE, Kind.ADAPTER,
                             Kind.KERNEL}),
    preload_to_gpu=True, fast_checkpoint=True,
    adaptive_batching=True, dynamic_offload=True)

SERVERLESS_LLM = Policy(
    name="ServerlessLLM", share_backbone=False,
    preload_kinds=frozenset({Kind.BACKBONE}),
    preload_to_gpu=False, fast_checkpoint=True,
    adaptive_batching=False, fixed_batch=4, fixed_delay=0.25)

INSTAINFER = Policy(
    name="InstaInfer", share_backbone=False,
    preload_kinds=frozenset({Kind.LIBRARY, Kind.BACKBONE, Kind.ADAPTER}),
    preload_to_gpu=False, fast_checkpoint=False,
    adaptive_batching=False, fixed_batch=4, fixed_delay=0.25)

VLLM = Policy(name="vLLM", serverful=True, share_backbone=False,
              adaptive_batching=True)

DLORA = Policy(name="dLoRA", serverful=True, share_backbone=True,
               adaptive_batching=True)


# ---- ablation variants (paper §6.6) ----
def variant_nbs() -> Policy:      # no backbone sharing
    return dataclasses.replace(SERVERLESS_LORA, name="ServerlessLoRA-NBS",
                               share_backbone=False)


def variant_npl() -> Policy:      # no pre-loading
    return dataclasses.replace(SERVERLESS_LORA, name="ServerlessLoRA-NPL",
                               preload_kinds=frozenset())


def variant_ndo() -> Policy:      # no dynamic offloading
    return dataclasses.replace(SERVERLESS_LORA, name="ServerlessLoRA-NDO",
                               dynamic_offload=False)


def variant_nab(batch: int, delay: float, tag: str) -> Policy:
    return dataclasses.replace(
        SERVERLESS_LORA, name=f"ServerlessLoRA-NAB {tag}",
        adaptive_batching=False, fixed_batch=batch, fixed_delay=delay)


ALL_BASELINES = [SERVERLESS_LORA, SERVERLESS_LLM, INSTAINFER, VLLM, DLORA]
