"""End-to-end serving example: a warm ServerlessLoRA function pool serving
batched requests across multiple LoRA adapters on one shared backbone
(port of ``examples/serve_multilora.py``) — the request-serving stage of
the paper's workflow (steps 4–7) with real prefill (flash) and captured
ring decode steps (SGMV at every LoRA site), plus the adaptive batching
scheduler deciding batch sizes/delays from a profile calibrated on one
measured prefill.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_multilora
     [--requests 24] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.engine import InferenceEngine
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.serverless.batching import (BatchingScheduler, BatchProfile,
                                             Request)

PROMPT_LEN = 32


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg: ModelConfig, params: Dict[str, Any],
        profile_tokens: torch.Tensor,
        draw_prompts: Callable[[int, int], torch.Tensor], *,
        requests: int, adapters: int, max_new: int, device="cuda",
        clock: Callable[[], float] = time.perf_counter) -> Dict[str, Any]:
    """Serve ``requests`` requests over ``adapters`` functions on
    ``params`` (a full tree with a stacked bank of ``adapters`` adapters
    on ``device``).  The batching profile's T0 is one prefill of
    ``profile_tokens`` ((1, 32) ids) timed on ``clock``;
    ``draw_prompts(served, b)`` gives the (b, 32) prompts of a batch
    dispatched after ``served`` requests.  Returns ``t0_s``, the
    ``dispatches`` (virtual time, fn_id, batch size, output shape, first
    tokens), ``served``, ``tokens`` and ``wall_s``."""
    device = torch.device(device)
    eng = InferenceEngine(cfg, params, max_context=96, device=device)

    # adaptive batching: profile from a real measured prefill
    t0 = clock()
    eng.prefill(profile_tokens.to(device),
                torch.zeros((1,), dtype=torch.int32, device=device))
    _sync(device)
    t_one = clock() - t0
    prof = BatchProfile(t0=t_one, alpha=t_one * 0.1, max_batch=8)
    sched = BatchingScheduler(adaptive=True)
    rng = np.random.default_rng(0)

    print(f"profile: T0={prof.t0 * 1000:.1f}ms α={prof.alpha * 1000:.2f}ms "
          f"B_max={prof.max_batch}")

    # synthetic request stream: one queue per adapter-function
    for a in range(adapters):
        sched.register(f"fn{a}", prof)
    now = 0.0
    for i in range(requests):
        sched.push(Request(req_id=i, fn_id=f"fn{rng.integers(adapters)}",
                           arrival=now, prompt_len=PROMPT_LEN,
                           output_len=max_new, slo_ttft=2.5))
        now += float(rng.exponential(0.01))

    served = 0
    dispatches = []
    t_start = clock()
    while served < requests:
        ready = sched.ready_queues(now)
        if not ready:
            nt = sched.next_timer(now)
            now = nt if nt is not None else now + 0.01
            continue
        for q in ready:
            batch = q.pop_batch()
            if not batch:
                continue
            b = len(batch)
            a_idx = torch.full((b,), int(q.fn_id[2:]), dtype=torch.int32,
                               device=device)
            prompts = draw_prompts(served, b).to(device)
            out, _ = eng.generate(prompts, max_new, adapter_idx=a_idx)
            served += b
            first = out[:, 0].tolist()
            dispatches.append((now, q.fn_id, b, tuple(out.shape), first))
            print(f"t={now:7.3f}s dispatched {q.fn_id} batch={b} "
                  f"out={tuple(out.shape)} first tokens={first}")
    _sync(device)
    wall = clock() - t_start
    toks = served * max_new
    where = "CPU" if device.type == "cpu" else torch.cuda.get_device_name(
        device)
    print(f"\nserved {served} requests / {toks} tokens in {wall:.2f}s "
          f"({toks / wall:.1f} tok/s on {where})")
    return {"t0_s": t_one, "dispatches": dispatches, "served": served,
            "tokens": toks, "wall_s": wall, "captures": eng.captures()}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--adapters", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke("llama2_7b").with_(name="serve-demo")
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, args.device,
                            lora_adapters=args.adapters)
    profile_tokens = torch.randint(0, cfg.vocab_size, (1, PROMPT_LEN),
                                   generator=gen, device=args.device,
                                   dtype=torch.int32)

    def draw_prompts(served: int, b: int) -> torch.Tensor:
        g = torch.Generator(device=args.device)
        g.manual_seed(served)
        return torch.randint(0, cfg.vocab_size, (b, PROMPT_LEN), generator=g,
                             device=args.device, dtype=torch.int32)

    return run(cfg, params, profile_tokens, draw_prompts,
               requests=args.requests, adapters=args.adapters,
               max_new=args.max_new, device=args.device)


if __name__ == "__main__":
    main()
