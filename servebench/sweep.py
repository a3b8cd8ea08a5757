"""Find a cell's knee: serve its mix at several Poisson rates on one built
system and print, for each, the end-to-end metrics and whether the queue
grew across the window.

    python3 servebench/sweep.py --workload <name> --seed <n> \\
        --seconds <s> --rates 2,3,4

The knee is the highest rate whose ``ttft_p95_ms`` stays under the mix's
``slo_ttft_s`` with no queue growing across the window; a cell's mix runs
at about four fifths of it.  Used once, when a cell is defined; the
benchmark's runs do not run it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != Path(__file__).resolve().parent]
ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    from servebench import model, spec
    from servebench.run import end_to_end, serve
    cell = spec.load_cell(args.workload, ROOT)
    system = model.build(cell.config, args.seed, torch.device("cuda"))
    print(f"built in {time.perf_counter() - T_START:.1f} s", flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(cell.traffic)
        mix["arrivals"]["rate_per_s"] = rate
        run = serve(system, cell, args.seed, args.seconds, False, mix)
        loop = run.loop
        row = {"rate_per_s": rate}
        for m in ("ttft_p50_ms", "ttft_p95_ms", "tpot_p95_ms",
                  "output_tokens_per_s"):
            row[m] = end_to_end(m, loop, args.seconds)
        due = [r for r in loop.records.values()
               if 0.0 <= r.req.due < args.seconds]
        half = args.seconds / 2
        row["due"] = len(due)
        row["unbound_at_end"] = sum(1 for r in due
                                    if not r.bound <= args.seconds)
        row["ttft_p95_ms_first_half"] = end_to_end(
            "ttft_p95_ms", _subset(loop, 0.0, half), args.seconds)
        row["ttft_p95_ms_second_half"] = end_to_end(
            "ttft_p95_ms", _subset(loop, half, args.seconds), args.seconds)
        row["slots_active_at_end"] = system.rt.slots.num_active
        print(json.dumps(row), flush=True)
        for st in list(system.rt.slots.active()):
            system.rt.abort(st.req.req_id)
    return 0


class _subset:
    """The loop's records due in [lo, hi), for one half's percentile."""

    def __init__(self, loop, lo, hi):
        self.records = {k: r for k, r in loop.records.items()
                        if lo <= r.req.due < hi}


if __name__ == "__main__":
    sys.exit(main())
