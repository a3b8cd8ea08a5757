"""The paper's evaluation setup (§6.1) mapped onto the simulator: 4
Llama-2-7B LoRA functions + 4 Llama-2-13B LoRA functions, Azure-like
traces in three CoV patterns, the cluster of four TPU-slice-sized devices
(port of ``benchmarks/common.py``'s setup, without its result writer)."""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs import get_config
from repro_torch.serverless import baselines as B
from repro_torch.serverless.cluster import Cluster
from repro_torch.serverless.latency import SLICE_HW
from repro_torch.serverless.simulator import FunctionDef
from repro_torch.serverless.traces import TraceSpec, make_workload

PATTERNS = ("predictable", "normal", "bursty")
SLO_7B, SLO_13B = 2.5, 4.0


def paper_functions() -> List[FunctionDef]:
    l7 = get_config("llama2_7b")
    l13 = get_config("llama2_13b")
    return ([FunctionDef(f"fn7-{i}", "llama2-7b", l7) for i in range(4)] +
            [FunctionDef(f"fn13-{i}", "llama2-13b", l13) for i in range(4)])


def paper_workload(pattern: str, duration: float = 1800.0,
                   seed: int = 7, rate_scale: float = 1.0) -> List[Dict]:
    specs = ([TraceSpec(f"fn7-{i}", pattern, 0.02 * rate_scale, duration,
                        prompt_len=512, output_len=48, slo_ttft=SLO_7B)
              for i in range(4)] +
             [TraceSpec(f"fn13-{i}", pattern, 0.012 * rate_scale, duration,
                        prompt_len=512, output_len=48, slo_ttft=SLO_13B)
              for i in range(4)])
    return make_workload(specs, seed=seed)


def paper_cluster(n_slices: int = 4) -> Cluster:
    return Cluster(num_nodes=1, gpus_per_node=n_slices, containers_per_gpu=2,
                   hbm_bytes=SLICE_HW.hbm_bytes,
                   host_bytes=SLICE_HW.host_mem_bytes)


ALL_POLICIES = [B.SERVERLESS_LORA, B.SERVERLESS_LLM, B.INSTAINFER,
                B.VLLM, B.DLORA]
SERVERLESS_POLICIES = [B.SERVERLESS_LORA, B.SERVERLESS_LLM, B.INSTAINFER]
