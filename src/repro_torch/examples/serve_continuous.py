"""Continuous-batching serving demo: a bursty 3-adapter trace replayed
through the paged multi-LoRA runtime (port of
``examples/serve_continuous.py``).  Requests join free decode slots
mid-flight (chunked paged prefill writing K/V straight into pool blocks)
and leave on completion (block refcounts drop; the last holder frees) —
the serving-side realization of the paper's §4.2 batching + §4.4 unmerged
multi-LoRA engine.  Each function's requests share a system prompt, so
admissions map already-resident prefix blocks and skip recomputing them
(--shared-prefix 0 to disable).  On the card both dispatches are captured
once as CUDA graphs and run the paged prefill, paged decode and SGMV
kernels.

Run: PYTHONPATH=src python -m repro_torch.examples.serve_continuous
     [--rate 2.0] [--device cpu]
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.lora import (_map, partition_lora, take_adapter,
                                   tree_leaves)
from repro_torch.core.sampling import MODES
from repro_torch.models import transformer as tf
from repro_torch.models.cache import state_bytes_per_slot
from repro_torch.models.config import ModelConfig
from repro_torch.serverless.traces import TraceSpec, make_workload
from repro_torch.serving import (AdapterRegistry, ContinuousRuntime,
                                 SamplingParams, ServingConfig, Telemetry,
                                 replay_trace, write_metrics_json)

ARCHS = ["llama2_7b", "mamba2_780m", "recurrentgemma_9b"]


def rand_adapter(params: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """Random A and B, N(0, 0.05), for one adapter of ``params``'s bank,
    drawn from a generator seeded ``seed`` on the bank's device (the init
    leaves B = 0, a zero delta — fine for shapes, useless for a
    multi-adapter demo)."""
    one = take_adapter(partition_lora(params)[1], 0)
    device = tree_leaves(one)[0].device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return _map(one, lambda x, _: None if x is None else (torch.randn(
        x.shape, generator=gen, device=device) * 0.05).to(x.dtype))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama2_7b", choices=ARCHS,
                    help="smoke config to serve: llama2 (attention-only "
                         "paged KV), mamba2 (pure-SSD slot state) or "
                         "recurrentgemma (hybrid REC+local-attention)")
    ap.add_argument("--adapters", type=int, default=3)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="mean requests/s per adapter function")
    ap.add_argument("--duration", type=float, default=15.0)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--output-len", type=int, default=16)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--events", type=int, default=24,
                    help="how many join/leave events to print")
    ap.add_argument("--shared-prefix", type=int, default=16,
                    help="per-function system-prompt tokens shared by "
                         "every request (0 = unique random prompts)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="softmax temperature for every request (0 = "
                         "greedy argmax, the default). Sampling params "
                         "ride the dispatch as data, so any mix still "
                         "captures the decode step exactly once")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep only the k highest-probability tokens "
                         "before sampling (0 = no top-k cut)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling: keep the smallest prefix of "
                         "tokens with cumulative probability >= p "
                         "(1.0 = no nucleus cut)")
    ap.add_argument("--sampling-seed", type=int, default=None,
                    help="base RNG seed for sampled requests; request i "
                         "draws with seed+i so rows differ. Default: "
                         "each request seeds from its own req_id")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON timeline of "
                         "the replay (open at https://ui.perfetto.dev): "
                         "one track per decode slot, a queue track, a "
                         "host dispatch track, and a wall-clock host-"
                         "plan/device-execute track")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the runtime metrics snapshot as JSON "
                         "(counters, pool/slot gauges, TTFT/TPOT "
                         "percentiles, host-bubble fraction)")
    ap.add_argument("--device", default="cuda")
    return ap


def run(args: argparse.Namespace, cfg: ModelConfig, params: Dict[str, Any],
        adapters: Sequence[Dict[str, Any]], *,
        timer: Callable[[], float] = time.perf_counter,
        on_runtime: Optional[Callable[[ContinuousRuntime], Any]] = None
        ) -> Dict[str, Any]:
    """Replay the flags' trace through a ``ContinuousRuntime`` over
    ``params`` (on ``args.device``, its bank holding at least
    ``len(adapters)`` slots), with ``adapters[a]`` loaded as ``fn{a}``;
    ``timer`` is the runtime's wall clock; ``on_runtime(rt)`` is called
    once the runtime exists, before any dispatch (a caller attaches its
    ``CompileGuard`` there).  Prints the reference's lines and returns the
    replay's ``result`` and ``events``, each request's ``tokens``, the
    requests ``served``, ``tokens_per_s`` on the replay clock, the
    runtime's ``stats`` and metrics ``snapshot``, the blocks
    ``in_use_after_drain`` and the ``runtime``."""
    if args.shared_prefix >= args.prompt_len:
        raise SystemExit("--shared-prefix must be < --prompt-len")
    scfg = ServingConfig(
        num_slots=args.slots, block_size=8, num_blocks=96,
        max_blocks_per_slot=8, prefill_chunk=16, decode_chunk=4)
    rt = ContinuousRuntime(cfg, params, scfg, device=args.device,
                           timer=timer)
    if on_runtime is not None:
        on_runtime(rt)
    reg = AdapterRegistry(rt)
    for a, adapter in enumerate(adapters):
        reg.load(f"fn{a}", adapter)
    print(f"registry: {len(adapters)} named adapters live in a "
          f"{reg.capacity}-slot bank, one backbone resident "
          f"({', '.join(reg.names())})")
    if args.arch != "llama2_7b":
        print(f"{args.arch}: hybrid/attention-free stack — each slot pins "
              f"{state_bytes_per_slot(cfg)} B of dense REC/SSD state "
              f"beside its paged KV blocks")

    specs = [TraceSpec(f"fn{a}", "bursty", args.rate, args.duration,
                       prompt_len=args.prompt_len,
                       output_len=args.output_len, slo_ttft=3.0)
             for a in range(len(adapters))]
    wl = make_workload(specs, seed=args.seed)
    fn_adapter = {f"fn{a}": f"fn{a}" for a in range(len(adapters))}
    print(f"trace: {len(wl)} requests over {args.duration}s, "
          f"{len(adapters)} bursty adapter functions, "
          f"{args.shared_prefix}-token shared system prompt per function")

    prompts = None
    if args.shared_prefix:
        rng = np.random.default_rng(args.seed)
        sys_p = {fn: rng.integers(0, cfg.vocab_size, args.shared_prefix,
                                  dtype=np.int32) for fn in fn_adapter}
        prompts = {w["req_id"]: np.concatenate(
            [sys_p[w["fn_id"]],
             rng.integers(0, cfg.vocab_size,
                          w["prompt_len"] - args.shared_prefix,
                          dtype=np.int32)]) for w in wl}

    sampling = None
    if args.temperature > 0.0:
        sampling = {
            w["req_id"]: SamplingParams(
                temperature=args.temperature, top_k=args.top_k,
                top_p=args.top_p,
                seed=(None if args.sampling_seed is None
                      else args.sampling_seed + w["req_id"]))
            for w in wl}
        mode = next(iter(sampling.values())).mode()
        print(f"sampling: mode={mode} temperature={args.temperature} "
              f"top_k={args.top_k} top_p={args.top_p} "
              f"(per-request counter-based RNG: token i of request r "
              f"depends only on (seed_r, i))")

    tele = Telemetry() if args.trace_out else None
    tokens: Dict[int, List[int]] = {}
    res, events = replay_trace(rt, wl, fn_adapter, seed=args.seed,
                               collect_events=True, prompts=prompts,
                               telemetry=tele, sampling=sampling,
                               token_sink=tokens)

    print(f"\nfirst {args.events} runtime events "
          f"(virtual clock — measured device time):")
    for e in events[: args.events]:
        print(f"  t={e.t:8.4f}s {e.kind:7s} req{e.req_id:<4d} "
              f"slot={e.slot:<2d} {e.detail}")

    ok = [r for r in res.requests if r.first_token >= 0]
    rejected = sum(1 for r in res.requests
                   if "rejected_too_long" in r.breakdown)
    abandoned = len(res.requests) - len(ok) - rejected
    toks = sum(r.output_len for r in ok)
    horizon = max((r.done for r in ok), default=1e-9)
    print(f"\nserved {len(ok)}/{len(res.requests)} requests "
          f"({abandoned} abandoned past SLO, {rejected} rejected: "
          f"prompt+output over slot capacity)")
    print(f"mean TTFT {res.mean_ttft * 1000:7.1f} ms   "
          f"p99 TTFT {res.p99_ttft * 1000:7.1f} ms")
    print(f"mean TPOT {res.mean_tpot * 1000:7.2f} ms   "
          f"throughput {toks / horizon:7.1f} tok/s (virtual)")
    print(f"SLO violations {res.slo_violation_rate * 100:.1f}%")
    print(f"pool: {rt.pool.num_blocks} blocks x {rt.pool.block_size} tokens, "
          f"in use after drain: {rt.pool.in_use} (must be 0), "
          f"{rt.pool.num_cached} cached prefix blocks, "
          f"high-water {rt.pool.high_water}")
    st = rt.stats
    if st["prompt_tokens"]:
        pct = 100.0 * st["shared_tokens"] / st["prompt_tokens"]
        rec = 100.0 * st["recomputed_tokens"] / st["prompt_tokens"]
        print(f"prefix sharing: {st['shared_tokens']}/"
              f"{st['prompt_tokens']} prompt tokens ({pct:.0f}%) mapped "
              f"from resident blocks ({st['shared_block_maps']} block maps)")
        if not rt.needs_kv:
            tail = ("attention-free stack: no KV blocks exist, so there "
                    "is nothing to share or skip")
        elif rt.has_state:
            tail = ("covered prefixes skip insert only (REC/SSD state "
                    "must integrate every prefix token)")
        else:
            tail = "covered prefixes skip compute, not just insert"
        print(f"chunked prefill: {st['recomputed_tokens']} tokens "
              f"({rec:.0f}% of prompts) computed in "
              f"{st['prefill_chunks']} chunk dispatches — {tail}")
    print("\nmixed-adapter stats (one SGMV-dispatched backbone, "
          "per-slot deltas):")
    print(f"  {'adapter':10s} {'slot':>4s} {'served':>6s} "
          f"{'tokens':>7s} {'mean TTFT':>10s} {'p-worst':>9s}")
    for name in reg.names():
        mine = [r for r in ok if r.fn_id == name]
        if not mine:
            print(f"  {name:10s} {reg.slot_of(name):4d} {0:6d}")
            continue
        ttfts = [r.first_token - r.arrival for r in mine]
        print(f"  {name:10s} {reg.slot_of(name):4d} {len(mine):6d} "
              f"{sum(r.output_len for r in mine):7d} "
              f"{np.mean(ttfts) * 1e3:8.1f}ms {np.max(ttfts) * 1e3:7.1f}ms")
    print(f"  adapter loads {st['adapter_loads']}, unloads "
          f"{st['adapter_unloads']}, rejected (unknown adapter) "
          f"{st['rejected_unknown_adapter']}")
    by_mode = {m: st[f"tokens_mode_{m}"] for m in MODES
               if st[f"tokens_mode_{m}"]}
    print(f"sampling: {st['sampled_tokens']} non-greedy tokens; "
          f"accepted tokens by mode: {by_mode}")
    print(f"decode compiles after warmup: {rt.decode_compiles()}, "
          f"prefill compiles: {rt.prefill_compiles()} "
          f"(fixed shapes -> exactly 1 each)")
    snap = rt.metrics_snapshot()
    h = snap["histograms"]
    print(f"host-bubble fraction: {snap['host_bubble_fraction']:.3f} "
          f"over {snap['dispatches']} dispatches "
          f"(device idle while the host plans)")
    if "ttft_s" in h and "tpot_s" in h:      # empty on a zero-serve trace
        print(f"TTFT p50/p95/p99: {h['ttft_s']['p50'] * 1e3:.1f}/"
              f"{h['ttft_s']['p95'] * 1e3:.1f}/"
              f"{h['ttft_s']['p99'] * 1e3:.1f} ms   "
              f"TPOT p50/p99: {h['tpot_s']['p50'] * 1e3:.2f}/"
              f"{h['tpot_s']['p99'] * 1e3:.2f} ms")
    if args.metrics_out:
        write_metrics_json(snap, args.metrics_out)
        print(f"metrics snapshot -> {args.metrics_out}")
    if tele is not None:
        tele.write_chrome_trace(args.trace_out)
        print(f"chrome trace -> {args.trace_out} "
              f"({len(tele.spans)} spans, {len(tele.instants)} events; "
              f"open at https://ui.perfetto.dev)")
    return {"result": res, "events": events, "tokens": tokens,
            "served": len(ok), "tokens_per_s": toks / horizon,
            "stats": dict(st), "snapshot": snap,
            "in_use_after_drain": rt.pool.in_use, "runtime": rt}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    args = build_parser().parse_args(argv)
    cfg = get_smoke(args.arch).with_(name="serve-continuous",
                                     dtype="float32")
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, args.device,
                            lora_adapters=args.adapters)
    adapters = [rand_adapter(params, 100 + a) for a in range(args.adapters)]
    return run(args, cfg, params, adapters)


if __name__ == "__main__":
    main()
