"""Quickstart: the ServerlessLoRA core in five minutes (port of
``examples/quickstart.py``).

1. Build a small backbone, register it in the shared BackboneStore.
2. Spin up three isolated LoRA "functions" sharing that backbone zero-copy.
3. Serve a batched multi-adapter request (unmerged LoRA, per-request
   adapter routing: flash prefill, ring decode and SGMV on the card).
4. Run the serverless simulator for one bursty hour and print the
   ServerlessLoRA vs ServerlessLLM comparison.

Run: PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import copy
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.lora import partition_lora, tree_leaves
from repro_torch.core.sharing import BackboneStore, FunctionInstance
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serverless import baselines as B
from repro_torch.serverless.simulator import FunctionDef, Simulator
from repro_torch.serverless.traces import TraceSpec, make_workload


def simulate() -> List[str]:
    """Step 4: four Llama-2-7B functions on one bursty 15-minute trace
    under ServerlessLoRA and ServerlessLLM; one printed line each (host
    only)."""
    l7 = get_config("llama2_7b")
    sim_fns = [FunctionDef(f"fn{i}", "llama2-7b", l7) for i in range(4)]
    specs = [TraceSpec(f"fn{i}", "bursty", 0.02, 900.0, 512, 48, 2.5)
             for i in range(4)]
    wl = make_workload(specs, seed=1)
    lines = []
    for pol in (B.SERVERLESS_LORA, B.SERVERLESS_LLM):
        res = Simulator(sim_fns, pol).run(copy.deepcopy(wl))
        lines.append(f"{pol.name:15s} TTFT={res.mean_ttft * 1000:6.0f}ms "
                     f"cost=${res.dollars:.3f} "
                     f"cost-effectiveness={res.cost_effectiveness:.3f}")
    return lines


def run(cfg: ModelConfig, params: Dict[str, Any], prompts: torch.Tensor, *,
        device="cuda") -> Dict[str, Any]:
    """Steps 1-4 on ``params`` (a full tree with a stacked bank of 3
    adapters on ``device``) and ``prompts`` ((3, T) int token ids, one row
    per adapter).  Returns the generated ``tokens`` (3 lists), the
    ``zero_copy`` (shared, total) leaf counts and the ``simulator`` lines."""
    # --- 1. one backbone, many adapters (multi-LoRA bank of 3) -----------
    store = BackboneStore()
    store.register(cfg.name, cfg, params)
    print(f"registered backbone: {store.nbytes(cfg.name) / 2**20:.1f}"
          f" MiB shared, refcount={store.refcount(cfg.name)}")

    # --- 2. three isolated functions, zero-copy backbone handles ---------
    _, adapters = partition_lora(params)
    fns = [FunctionInstance(f"fn{i}", store.open(cfg.name), adapters,
                            adapter_index=i) for i in range(3)]
    assert store.refcount(cfg.name) == 3
    ptrs = [[x.data_ptr() for x in tree_leaves(f.params)] for f in fns]
    shared = sum(1 for x, y in zip(ptrs[0], ptrs[1]) if x == y)
    print(f"zero-copy: {shared}/{len(ptrs[0])} leaves shared between "
          f"functions")
    own = [x.data_ptr() for x in tree_leaves(partition_lora(params)[0])]
    assert all([x.data_ptr() for x in tree_leaves(partition_lora(
        f.params)[0])] == own for f in fns), "a backbone leaf was copied"

    # --- 3. batched multi-adapter serving ---------------------------------
    eng = InferenceEngine(cfg, params, max_context=64, device=device)
    adapter_idx = torch.tensor([0, 1, 2], dtype=torch.int32, device=device)
    out, _ = eng.generate(prompts.to(device), 8, adapter_idx=adapter_idx)
    tokens = out.tolist()
    print("generated (one row per function/adapter):")
    for i, row in enumerate(tokens):
        print(f"  fn{i} (adapter {i}):", row)

    # --- 4. serverless simulation -----------------------------------------
    lines = simulate()
    for line in lines:
        print(line)
    for f in fns:
        f.close()
    return {"tokens": tokens, "zero_copy": (shared, len(ptrs[0])),
            "simulator": lines}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_smoke("llama2_7b").with_(name="demo-backbone")
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, args.device, lora_adapters=3)
    prompts = torch.randint(0, cfg.vocab_size, (3, 12), generator=gen,
                            device=args.device, dtype=torch.int32)
    return run(cfg, params, prompts, device=args.device)


if __name__ == "__main__":
    main()
