"""Analytic latency model: loading tiers + roofline inference times.

A copy of the reference's model (``repro/serverless/latency.py``): it
feeds ``batching.profile_function`` and the simulator's cold-start stages.
Three hardware profiles:

* ``DEFAULT_HW`` and ``SLICE_HW`` are the reference's TPU v5e stand-in
  constants, kept as they are so the port's simulator reproduces the
  reference's results; they are not measurements of any card.
* ``H100_HW`` is one NVIDIA H100: ``peak_flops``, ``hbm_bw`` and
  ``hbm_bytes`` from its data sheet, and ``h2d_bw``, ``runtime_init_s``,
  ``library_load_s`` and ``kernel_compile_s`` measured by
  ``chip_smoke.py`` phase 14.  ``remote_bw``, ``ici_bw``,
  ``container_init_s`` and ``host_mem_bytes`` stay the reference's
  stand-ins: nothing in the port measures them.

The serving replay never reads these profiles — it profiles the prefill
step it actually runs (``ContinuousRuntime.warmup``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class Hardware:
    """TPU v5e-like accelerator + host."""
    peak_flops: float = 197e12          # bf16 FLOP/s per chip
    hbm_bw: float = 819e9               # B/s
    hbm_bytes: int = 16 * 2 ** 30       # 16 GB per chip
    ici_bw: float = 50e9                # B/s per link
    h2d_bw: float = 32e9                # host → device (PCIe4 x16-like)
    remote_bw: float = 1.5e9            # object storage → host
    host_mem_bytes: int = 192 * 2 ** 30  # DRAM per container slot group

    container_init_s: float = 1.8       # cold container start
    runtime_init_s: float = 1.2         # device runtime/context bring-up
    library_load_s: float = 6.5         # ML libraries import (paper Fig 1)
    kernel_compile_s: float = 3.5       # JIT compile (XLA/CUDA) per function


DEFAULT_HW = Hardware()

# One serving "accelerator" in the simulator = a v5e-4 slice (4 chips
# aggregated), the TPU analogue of the paper's 48 GB L40S: big enough to
# host a 13B backbone plus KV. Roofline terms scale linearly in chips.
SLICE_HW = Hardware(
    peak_flops=4 * 197e12, hbm_bw=4 * 819e9, hbm_bytes=64 * 2 ** 30)

# One NVIDIA H100 80GB HBM3.  The measured fields are the medians of one
# run of chip_smoke.py phase 14 on one NVIDIA H100 80GB HBM3 whose
# nvidia-smi power limit read 700.00 W; PERF.md section 5 names the run
# and gives its spread beside another run's.
H100_HW = Hardware(
    peak_flops=989e12,            # bf16 dense, data sheet (at 700 W)
    hbm_bw=3.35e12,               # HBM3, data sheet
    hbm_bytes=80 * 2 ** 30,
    h2d_bw=38.72e9,               # measured: 13.477 GB pinned tier -> card
    runtime_init_s=0.4487,        # measured: CUDA init + 1st allocation
    library_load_s=10.7275,       # measured: import torch + repro_torch
    kernel_compile_s=1.0184,      # measured: kernel library, 1st prefill
                                  # excess, batch-1 decode-step capture
    # stand-ins, the reference's values (nothing here measures them):
    # remote_bw, ici_bw, container_init_s, host_mem_bytes
)


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    hw: Hardware = DEFAULT_HW

    # ---- loading ----
    def remote_to_host_s(self, nbytes: int) -> float:
        return nbytes / self.hw.remote_bw

    def host_to_gpu_s(self, nbytes: int) -> float:
        return nbytes / self.hw.h2d_bw

    # ---- inference (single chip; roofline) ----
    def prefill_s(self, cfg: ModelConfig, prompt_len: int,
                  batch: int = 1) -> float:
        n = cfg.active_param_count()
        flops = 2.0 * n * prompt_len * batch
        t_compute = flops / self.hw.peak_flops
        t_memory = 2.0 * n / self.hw.hbm_bw   # weights streamed once (bf16)
        return max(t_compute, t_memory)

    def prefill_t0_alpha(self, cfg: ModelConfig, prompt_len: int):
        """T(b) = T0 + α(b-1) linearisation (paper Eq. 2)."""
        t0 = self.prefill_s(cfg, prompt_len, 1)
        t2 = self.prefill_s(cfg, prompt_len, 2)
        return t0, max(t2 - t0, 1e-4)

    def decode_s_per_token(self, cfg: ModelConfig, batch: int = 1,
                           context: int = 1024) -> float:
        n = cfg.active_param_count()
        itemsize = 2
        weight_bytes = n * itemsize
        if cfg.family == "ssm":
            kv = cfg.num_layers * cfg.d_inner * cfg.ssm_state_dim * 4
        else:
            eff = min(context, cfg.sliding_window or context)
            kv = (2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim_
                  * eff * itemsize)
        t_mem = (weight_bytes + batch * kv) / self.hw.hbm_bw
        t_compute = 2.0 * n * batch / self.hw.peak_flops
        return max(t_mem, t_compute)

    # ---- artifact latencies (for building Artifact objects) ----
    def backbone_bytes(self, cfg: ModelConfig) -> int:
        return cfg.param_count() * 2  # bf16

    def kv_bytes_per_request(self, cfg: ModelConfig, context: int) -> int:
        if cfg.family == "ssm":
            return cfg.num_layers * cfg.d_inner * cfg.ssm_state_dim * 4
        eff = min(context, cfg.sliding_window or context)
        return 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim_ * eff * 2
