"""The check's control, read on the card: for each seed, a short run of
the cell at its own load, then on the same sample of served requests the
program's widest logit gap and the float8 control's (the reference in
float8 put in the program's place).  The limit in the configuration file
lies between the two readings.

    python3 servebench/control.py --workload <name> --seconds <s> \\
        --seeds 1,2,3

The benchmark's runs do not run it.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
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
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from servebench import spec
    from servebench.run import run_cell
    cell = spec.load_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = run_cell(cell, seed, args.seconds, False, "cuda", t0,
                       control=True)
        row = {"seed": seed, "program": res.get("readings"),
               "control": res.get("control"),
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "counts": res["counts"],
               "s": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
