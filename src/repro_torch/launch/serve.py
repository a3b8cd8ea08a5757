"""Serving launcher: warm multi-LoRA functions serving batched requests
(port of ``repro/launch/serve.py``).

Boots a backbone into the ``BackboneStore``, opens N isolated LoRA
function handles, and serves a request stream through the adaptive
batching scheduler with real prefill/decode (``InferenceEngine`` over ring
caches: the flash and ring-decode kernels, SGMV at every LoRA site).

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --full  # on the card

Arrivals come from the reference's ``np.random.default_rng(0)`` and the
batching profile from the same ``LatencyModel(SLICE_HW)`` — the
simulator's analytic TPU-slice model, which only seeds the scheduler and
is no measurement of the card — so the port takes the reference's batching
decisions.  Weights come from ``init_params`` with a ``torch.Generator``
seeded 0, and each batch's prompts from a generator seeded by the number
of requests served before it: their values differ from the reference's
JAX PRNG draws.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.lora import partition_lora, tree_leaves
from repro_torch.core.sharing import BackboneStore, FunctionInstance
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serverless.batching import (BatchProfile, BatchingScheduler,
                                             Request)
from repro_torch.serverless.latency import SLICE_HW, LatencyModel


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama2_7b", choices=ARCH_IDS)
    ap.add_argument("--adapters", type=int, default=4)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--rate", type=float, default=50.0, help="req/s")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def serve(cfg: ModelConfig, params: Dict[str, Any],
          args: argparse.Namespace) -> Dict[str, Any]:
    """Serve ``args.requests`` requests on ``params`` (a full tree with a
    stacked bank of ``args.adapters`` adapters on ``args.device``).

    Returns the per-batch ``schedule`` of (fn_id, batch size), the output
    shapes, ``tokens``, ``wall_s``, the kernel ``launches`` made here, the
    engine's decode-step ``captures`` per (batch, context length), the
    store's open handles and, per function, the ``data_ptr``s of the
    backbone tensors its handle reads."""
    device = torch.device(args.device)
    # one shared backbone, N isolated functions (paper §4.4)
    store = BackboneStore()
    store.register(cfg.name, cfg, params)
    _, bank = partition_lora(params)
    fns = [FunctionInstance(f"fn{i}", store.open(cfg.name), bank, i)
           for i in range(args.adapters)]
    print(f"backbone {cfg.name}: {store.nbytes(cfg.name) / 2 ** 20:.1f} MiB "
          f"shared by {store.refcount(cfg.name)} functions (zero-copy)")
    open_handles = store.refcount(cfg.name)
    backbone_ptrs = [[t.data_ptr()
                      for t in tree_leaves(partition_lora(f.params)[0])]
                     for f in fns]

    engine = InferenceEngine(
        cfg, params, max_context=args.prompt_len + args.max_new + 8,
        device=device)

    # profile -> adaptive batching (Eq. 2/3 with roofline-derived T0/alpha)
    lat = LatencyModel(SLICE_HW)
    t0, alpha = lat.prefill_t0_alpha(cfg, args.prompt_len)
    sched = BatchingScheduler(adaptive=True)
    sched.rate_hint = lambda fn: args.rate / args.adapters
    for f in fns:
        sched.register(f.fn_id, BatchProfile(t0, alpha, max_batch=8))

    rng = np.random.default_rng(0)
    now, served, gen_tokens = 0.0, 0, 0
    pending = args.requests
    schedule: List[tuple] = []
    shapes: List[tuple] = []
    before = kernels.launch_counts()
    wall0 = time.perf_counter()
    i = 0
    while served < args.requests:
        if pending > 0:
            sched.push(Request(i, f"fn{rng.integers(args.adapters)}", now,
                               args.prompt_len, args.max_new, 2.5))
            pending -= 1
            i += 1
            now += float(rng.exponential(1.0 / args.rate))
        for q in sched.ready_queues(now):
            batch = q.pop_batch()
            if not batch:
                continue
            b = len(batch)
            a = torch.full((b,), int(q.fn_id[2:]), dtype=torch.int32,
                           device=device)
            gen = torch.Generator(device=device)
            gen.manual_seed(served)
            prompts = torch.randint(0, cfg.vocab_size, (b, args.prompt_len),
                                    generator=gen, device=device,
                                    dtype=torch.int32)
            out, _ = engine.generate(prompts, args.max_new, adapter_idx=a)
            served += b
            gen_tokens += out.numel()
            schedule.append((q.fn_id, b))
            shapes.append(tuple(out.shape))
            print(f"t={now:6.3f}s  {q.fn_id} batch={b} -> {tuple(out.shape)}")
        nt = sched.next_timer(now)
        if nt is not None and nt > now and pending == 0:
            now = nt
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - wall0
    after = kernels.launch_counts()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else device.type)
    print(f"\nserved {served} requests, {gen_tokens} tokens in {wall:.2f}s "
          f"({gen_tokens / wall:.0f} tok/s on {where})")
    for f in fns:
        f.close()
    return {"schedule": schedule, "shapes": shapes, "served": served,
            "tokens": gen_tokens, "wall_s": wall,
            "launches": {k: after[k] - before[k] for k in after},
            "captures": engine.captures(),
            "open_handles": open_handles, "backbone_ptrs": backbone_ptrs}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    if cfg.family in ("audio",):
        raise SystemExit("serve launcher demo supports decoder-only archs")
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, args.device,
                            lora_adapters=args.adapters)
    return serve(cfg, params, args)


if __name__ == "__main__":
    main()
