"""Monetary cost model (paper §6.1, Alibaba Function Compute style; port
of ``repro/serverless/costs.py``).

Serverless: pay-per-use — a GPU is billed whenever it is *reserved* for a
function (artifacts resident or inference running); host memory and CPU
likewise.  Serverful: billed wall-clock × instances regardless of load.
GPU ≈ 90 % of invocation cost (paper's observation), which the default
prices reflect.  Cost-effectiveness = 1 / (E2E latency × cost) (§2.1 fn 3).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Pricing:
    gpu_per_s: float = 190e-6 / (2 ** 30)     # $ per byte-second of HBM held
    host_per_s: float = 9e-6 / (2 ** 30)      # $ per byte-second of DRAM held
    cpu_per_core_s: float = 24e-6
    invoke_fee: float = 2e-7                  # per request


class CostMeter:
    """Integrates byte-seconds of GPU/host residency + CPU-seconds."""

    def __init__(self, pricing: Pricing = Pricing()):
        self.p = pricing
        self.gpu_byte_s = 0.0
        self.host_byte_s = 0.0
        self.cpu_core_s = 0.0
        self.invocations = 0
        self._last_t = 0.0
        self._gpu_bytes = 0
        self._host_bytes = 0
        self._cpu_cores = 0.0

    def advance(self, now: float) -> None:
        dt = max(now - self._last_t, 0.0)
        self.gpu_byte_s += self._gpu_bytes * dt
        self.host_byte_s += self._host_bytes * dt
        self.cpu_core_s += self._cpu_cores * dt
        self._last_t = now

    def set_usage(self, now: float, gpu_bytes: int, host_bytes: int,
                  cpu_cores: float) -> None:
        self.advance(now)
        self._gpu_bytes = gpu_bytes
        self._host_bytes = host_bytes
        self._cpu_cores = cpu_cores

    def count_invocation(self) -> None:
        self.invocations += 1

    @property
    def dollars(self) -> float:
        return (self.gpu_byte_s * self.p.gpu_per_s
                + self.host_byte_s * self.p.host_per_s
                + self.cpu_core_s * self.p.cpu_per_core_s
                + self.invocations * self.p.invoke_fee)


def cost_effectiveness(mean_e2e_s: float, dollars: float) -> float:
    return 1.0 / max(mean_e2e_s * dollars, 1e-12)
