"""Run one cell of the benchmark of ``repro_torch`` and print its result.

    python3 servebench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  Set-up builds the cell's model with weights
drawn on the card from the seed, loads its adapters through the registry,
captures its two dispatches (the kernels come from ``build/kernels/`` in
the checkout) and serves a pre-roll of the cell's traffic; then the
window is measured for ``--seconds`` on the wall clock.  ``--trace 1``
reports the per-layer metrics instead of the end-to-end ones: those read
from the driver's spans over the window's part before the profiler starts,
those from the program's counters over the window, those read from the
profiler over the window's last third.  Once the window has closed, the served tokens of a
sample of finished requests are held against the plain reference
(``check.py``).  The last line of standard output is the result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, this folder heads sys.path: put the checkout's root and
# its ``src`` there instead, so the harness imports as ``servebench``
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
TRACE_FROM = 2.0 / 3.0  # a traced run profiles the window's last third:
#   a profile of the whole window takes minutes to stop and read
TRACE_LEAD_S = 2.0     # the profiler starts this long before that
HOST_LABEL = {"decode": "runtime.decode call",
              "prefill": "runtime.try_admit call",
              "sleep": "driver asleep until the next request is due"}


def log(msg: str) -> None:
    print(f"servebench: {msg}", file=sys.stderr, flush=True)


def forbidden_modules():
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def end_to_end(metric: str, loop, seconds: float):
    """The end-to-end metrics, from the driver's records."""
    from servebench.readers import pct
    due = [r for r in loop.records.values()
           if 0.0 <= r.req.due < seconds]
    if metric in ("ttft_p50_ms", "ttft_p95_ms"):
        waits = [((r.first if r.first <= seconds else seconds) - r.req.due)
                 * 1e3 for r in due if not r.failed]
        return pct(waits, 50 if metric == "ttft_p50_ms" else 95)
    if metric == "tpot_p95_ms":
        gaps = []
        for r in due:
            seen = [(t, n) for t, n in r.times if t <= seconds]
            n = sum(k for _, k in seen)
            if n >= 2:
                gaps.append((seen[-1][0] - seen[0][0]) / (n - 1) * 1e3)
        return pct(gaps, 95)
    if metric == "output_tokens_per_s":
        return sum(n for r in loop.records.values() for t, n in r.times
                   if 0.0 <= t <= seconds) / seconds
    raise KeyError(f"no end-to-end metric {metric!r}")


@dataclasses.dataclass
class Served:
    loop: Any
    origin: float                  # clock reading of the window's start
    stats0: Dict[str, float]
    stats1: Dict[str, float]
    traced: Any
    host_until: float              # window time at which the profiler
    #   started (the window's end in an untraced run)


def serve(system, cell, seed: int, seconds: float, trace: bool,
          traffic: Optional[Dict[str, Any]] = None) -> Served:
    """The pre-roll and the window on a built system (``traffic``
    replaces the cell's mix, for the knee sweep)."""
    import torch

    from servebench import traffic as tr
    from servebench.driver import OpenLoop
    from servebench.tracing import Session

    mix = traffic or cell.traffic
    on_card = system.rt.device.type == "cuda"
    session = Session() if trace and on_card else None
    if session is not None:
        Session.warm_up()
    reqs = tr.generate(mix, cell.config["model"]["vocab_size"], seed,
                       seconds)
    loop = OpenLoop(system.rt, reqs, system.fn_names,
                    group=cell.config["serving"]["prefill_rows"],
                    slo_ttft=float(mix["slo_ttft_s"]),
                    origin=time.perf_counter() + float(
                        mix.get("preroll_s", 0.0)),
                    span=torch.profiler.record_function if trace else None)
    if trace:
        loop.tap_dispatches()
    loop.run_until(0.0)
    stats0 = dict(system.rt.stats)
    host_until = float(seconds)
    if session is not None:
        loop.run_until(seconds * TRACE_FROM - TRACE_LEAD_S)
        host_until = loop.now()
        session.start(loop.now, seconds * TRACE_FROM, seconds)
    loop.run_until(seconds)
    if on_card:
        torch.cuda.synchronize()
    stats1 = dict(system.rt.stats)
    loop.close_pending(loop.now())
    traced = None
    if session is not None:
        session.stop()
        traced = session.read()
    return Served(loop, loop.origin, stats0, stats1, traced, host_until)


def per_layer(cell, run: Served, seconds: float, dev):
    """The cell's per-layer metrics and the trace's breakdown.  The
    readers' context holds the runtime through the loop; it lives only in
    this call, so the program's state can be freed before the check."""
    import torch

    from servebench import model, readers, spec
    from servebench.tracing import breakdown

    peaks = {}
    if dev.type == "cuda":
        from servebench.peaks import peaks_of
        peaks = peaks_of(torch.cuda.get_device_name(dev))
    ctx = readers.Context(config=cell.config,
                          shapes=model.shapes(cell.config), seconds=seconds,
                          loop=run.loop, stats0=run.stats0,
                          stats1=run.stats1, trace=run.traced, peaks=peaks,
                          bench_dir=cell.bench_dir,
                          host_until=run.host_until)
    metrics = {}
    for m in cell.per_layer:
        val = spec.reader(cell.bench_dir, m["name"])(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    out = None
    traced = run.traced
    if traced is not None and traced.kernels:
        host = [(HOST_LABEL[s.kind], s.t0, s.t1) for s in run.loop.spans]
        out = breakdown(traced, host, traced.lo, traced.hi)
    return metrics, out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault=None, control: bool = False):
    """Set-up, pre-roll, window, check.  ``fault(system)`` may break the
    timed path underneath (the benchmark's own tests); ``control`` also
    reads the float8 control on the same sample."""
    import torch

    from servebench import check as chk
    from servebench import model
    from servebench.tracing import merge

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    config = cell.config
    system = model.build(config, seed, dev)
    log(f"built {config['name']}: {time.perf_counter() - t_start:.2f} s "
        f"after start, {system.num_blocks} pool blocks")
    if fault is not None:
        fault(system)
    rt = system.rt
    run = serve(system, cell, seed, seconds, trace)
    loop, traced = run.loop, run.traced
    setup_s = run.origin - t_start
    peak = (torch.cuda.max_memory_allocated(dev) if on_card else 0)
    metrics = {}
    out_breakdown = None
    if not trace:
        for m in cell.end_to_end:
            val = (setup_s if m["name"] == "setup_s"
                   else end_to_end(m["name"], loop, seconds))
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        metrics, out_breakdown = per_layer(cell, run, seconds, dev)
    recs = list(loop.records.values())
    attempted = sum(1 for r in recs if r.req.due < seconds)
    failed = sum(1 for r in recs if r.req.due < seconds and r.failed)
    counts = {"requests_due_in_window": sum(
        1 for r in recs if 0.0 <= r.req.due < seconds),
        "finished_in_window": sum(1 for r in recs
                                  if 0.0 <= r.done <= seconds),
        "stalled_slot_chunks": loop.stalls,
        "decode_captures": rt.decode_compiles(),
        "prefill_captures": rt.prefill_compiles(),
        "pool_blocks": system.num_blocks}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        busy, window_s = 0.0, float(seconds)
        if traced is not None:
            lo, hi = traced.lo, traced.hi
            busy = sum(min(e, hi) - max(s, lo) for s, e in merge(
                [(s, e) for _, s, e in traced.kernels]) if e > lo and s < hi)
            window_s = hi - lo
            counts.update(trace_start_s=traced.start_s,
                          trace_read_s=traced.read_s,
                          trace_kernels=len(traced.kernels),
                          trace_markers_seen=traced.markers_seen)
        device_info.update(busy_s=busy, window_s=window_s)
    del loop, rt, run
    weights = system.weights
    model.free_program(system)
    if on_card:
        counts["allocated_at_check_bytes"] = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    verdict = chk.check(config, weights, recs, seed, dev, control=control)
    counts["check_s"] = time.perf_counter() - t0
    limits = config["check"]["limits"]
    got = verdict["numbers"]
    compared = {name: {"value": got.get(name), "limit": float(limit)}
                for name, limit in limits.items()}
    correct = bool(compared) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in compared.values())
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if out_breakdown is not None:
        result["breakdown"] = out_breakdown
    counts.update(checked_requests=verdict["requests"],
                  checked_tokens=verdict["tokens"])
    result["counts"] = counts
    if control:
        result["control"] = verdict.get("control")
        result["readings"] = got
    result["compared"] = compared
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("servebench: no CUDA device", file=sys.stderr)
        return 2
    from servebench import spec
    cell = spec.load_cell(args.workload, ROOT)
    if torch.cuda.device_count() < cell.chips:
        print(f"servebench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"servebench: loaded {bad} in the measuring process",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
