"""Full serverless-platform simulation: the paper's evaluation in miniature
(port of ``examples/serverless_sim.py``).  Runs all five policies over the
three Azure-pattern workloads and prints the Table-1-style comparison + the
headline claims check.  Host only: ``--device`` is accepted for the
examples' common command line and touches nothing.

Run: PYTHONPATH=src python -m repro_torch.examples.serverless_sim
     [--duration 1800]
"""
from __future__ import annotations

import argparse
import copy
from typing import Dict, List, Optional

from repro_torch.examples.paper_setup import (ALL_POLICIES, PATTERNS,
                                              paper_cluster, paper_functions,
                                              paper_workload)
from repro_torch.serverless.simulator import Simulator


def run(duration: float, slices: int) -> Dict:
    """Simulate every policy on every pattern; print the reference's
    lines.  Returns ``results[pattern][policy]`` (mean TTFT / TPOT / E2E
    in s, dollars, SLO violation rate, cost-effectiveness) and the two
    headline reductions."""
    headline = {}
    results: Dict[str, Dict[str, Dict[str, float]]] = {}
    for pattern in PATTERNS:
        wl = paper_workload(pattern, duration)
        print(f"\n=== {pattern} ({len(wl)} requests) ===")
        print(f"{'policy':16s} {'TTFT':>8s} {'TPOT':>8s} {'E2E':>8s} "
              f"{'cost':>9s} {'SLO-viol':>9s} {'CE':>8s}")
        results[pattern] = {}
        for pol in ALL_POLICIES:
            sim = Simulator(paper_functions(), pol,
                            cluster=paper_cluster(slices))
            res = sim.run(copy.deepcopy(wl))
            headline[(pattern, pol.name)] = res
            results[pattern][pol.name] = {
                "mean_ttft_s": res.mean_ttft, "mean_tpot_s": res.mean_tpot,
                "mean_e2e_s": res.mean_e2e, "dollars": res.dollars,
                "slo_violation_rate": res.slo_violation_rate,
                "cost_effectiveness": res.cost_effectiveness}
            print(f"{pol.name:16s} {res.mean_ttft * 1000:7.0f}m "
                  f"{res.mean_tpot * 1000:7.2f}m "
                  f"{res.mean_e2e * 1000:7.0f}m "
                  f"${res.dollars:8.3f} "
                  f"{res.slo_violation_rate:8.1%} "
                  f"{res.cost_effectiveness:8.3f}")

    print("\n=== headline claims (paper: TTFT ↓ up to 86%, cost ↓ up to 89%) ===")
    best_ttft, best_cost = 0.0, 0.0
    for pattern in PATTERNS:
        ours = headline[(pattern, "ServerlessLoRA")]
        for other in ("ServerlessLLM", "InstaInfer", "vLLM"):
            o = headline[(pattern, other)]
            best_ttft = max(best_ttft, 1 - ours.mean_ttft / o.mean_ttft)
            best_cost = max(best_cost, 1 - ours.dollars / o.dollars)
    print(f"max TTFT reduction vs baselines: {best_ttft:.0%}")
    print(f"max cost reduction vs baselines: {best_cost:.0%}")
    return {"results": results, "max_ttft_reduction": best_ttft,
            "max_cost_reduction": best_cost}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=1800.0)
    ap.add_argument("--slices", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.duration, args.slices)


if __name__ == "__main__":
    main()
