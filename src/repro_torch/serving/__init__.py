"""Continuous-batching serving runtime of the port.

Layout (each module the counterpart of ``repro/serving/<name>.py``):
  * ``kv_pool``   — host-side paged KV block manager, refcounted lifecycle.
  * ``prefix``    — hash-trie of full prompt blocks (prefix sharing).
  * ``slots``     — decode-slot table + SLO admission scheduler.
  * ``runtime``   — chunked paged prefill / decode loop over the block
                    pools, running through the CUDA kernels on the card.
  * ``replay``    — feeds arrival traces through the runtime.
  * ``metrics`` / ``telemetry`` — counters, gauges, histograms, spans.
"""
from repro_torch.core.sampling import SamplingParams
from repro_torch.serving.kv_pool import BlockPool, blocks_for_tokens
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.replay import replay_requests, replay_trace
from repro_torch.serving.runtime import (ContinuousRuntime, DecodeConfig,
                                         PrefillConfig, ServeRequest,
                                         ServingConfig, terminal_state)
from repro_torch.serving.slots import AdmissionScheduler, SlotTable
from repro_torch.serving.telemetry import Telemetry

__all__ = [
    "AdmissionScheduler", "BlockPool", "ContinuousRuntime", "DecodeConfig",
    "MetricsRegistry", "PrefillConfig", "PrefixCache", "SamplingParams",
    "ServeRequest", "ServingConfig", "SlotTable", "Telemetry",
    "blocks_for_tokens", "replay_requests", "replay_trace",
    "terminal_state",
]
