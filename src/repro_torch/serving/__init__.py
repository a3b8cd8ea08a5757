"""Continuous-batching serving runtime of the port.

Layout (each module the counterpart of ``repro/serving/<name>.py``):
  * ``kv_pool``   — host-side paged KV block manager, refcounted lifecycle.
  * ``prefix``    — hash-trie of full prompt blocks (prefix sharing).
  * ``slots``     — decode-slot table + SLO admission scheduler.
  * ``runtime``   — chunked paged prefill / decode loop over the block
                    pools, running through the CUDA kernels on the card;
                    sliding-window reclamation.
  * ``graphs``    — each fixed-shape dispatch captured once as a CUDA
                    graph (the port's form of ``jax.jit``).
  * ``compile_guard`` — capture budgets over a block of serving code.
  * ``adapters``  — live LoRA adapter registry over the runtime's bank.
  * ``faults``    — deterministic fault plans (artifact faults, pool
                    squeezes, dispatch slowdowns) and the retry primitive.
  * ``replay``    — feeds arrival traces through the runtime.
  * ``metrics`` / ``telemetry`` — counters, gauges, histograms, spans;
                    the Chrome-trace and metrics-JSON exporters.
"""
from repro_torch.core.sampling import SamplingParams
from repro_torch.serving.adapters import AdapterRegistry
from repro_torch.serving.compile_guard import (CompileBudgetExceeded,
                                               CompileGuard)
from repro_torch.serving.faults import (ArtifactFault, ArtifactLoadError,
                                        DispatchSlowdown, FaultPlan,
                                        PoolSqueeze, retry_with_backoff)
from repro_torch.serving.graphs import GraphedDispatch
from repro_torch.serving.kv_pool import BlockPool, blocks_for_tokens
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.prefix import PrefixCache
from repro_torch.serving.replay import replay_requests, replay_trace
from repro_torch.serving.runtime import (AdapterConfig, ContinuousRuntime,
                                         DecodeConfig, PrefillConfig,
                                         RobustConfig, ServeRequest,
                                         ServingConfig, terminal_state)
from repro_torch.serving.slots import AdmissionScheduler, SlotTable
from repro_torch.serving.telemetry import Telemetry, write_metrics_json

__all__ = [
    "AdapterConfig", "AdapterRegistry", "AdmissionScheduler",
    "ArtifactFault", "ArtifactLoadError", "BlockPool",
    "CompileBudgetExceeded", "CompileGuard", "ContinuousRuntime",
    "DecodeConfig", "DispatchSlowdown", "FaultPlan", "GraphedDispatch",
    "MetricsRegistry", "PoolSqueeze", "PrefillConfig", "PrefixCache",
    "RobustConfig", "SamplingParams", "ServeRequest", "ServingConfig",
    "SlotTable", "Telemetry", "blocks_for_tokens", "replay_requests",
    "replay_trace", "retry_with_backoff", "terminal_state",
    "write_metrics_json",
]
