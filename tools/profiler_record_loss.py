#!/usr/bin/env python3
"""Where ``torch.profiler`` loses device records, on one CUDA card.

    python3 tools/profiler_record_loss.py [--sessions N]

Run from the root of a checkout.  Each profiled session launches 8 blocks
of 100 small kernels (8 different elementwise ops, so each record names
its block) and counts the records of each block.  Sessions run in three
ways: as launched the moment the session starts; between two runs of
``chip_smoke.MARKERS`` zero-cycle spin-kernel markers; and the same after
a ``chip_smoke.PROFILER_SETTLE_S`` wait, as ``chip_smoke.py::profiled``
brackets its sessions.  They run first in a fresh process, then after
``chip_smoke.py`` phase 3 (every kernel against its plain version),
which leaves some processes dropping the first records of every session.
Each line prints, per way, how many sessions kept all 800 records and
the per-block counts of those that did not (a loss at the start shows as
short early blocks, one at the end as short late blocks), then the
markers seen.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
OPS = ("add", "mul", "neg", "abs", "sqrt", "fill", "exp", "log")


def block_of(name: str) -> str:
    low = name.lower()
    if "spin_kernel" in low:
        return "marker"
    return next((op for op in OPS if op in low), "other")


def session(x: torch.Tensor, settle: float, markers: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launch = {"add": lambda: x.add_(1), "mul": lambda: x.mul_(1.0001),
              "neg": x.neg_, "abs": x.abs_, "sqrt": x.sqrt_,
              "fill": lambda: x.fill_(2.0), "exp": x.exp_, "log": x.log_}
    def bracket() -> None:
        for _ in range(markers):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(settle)
        bracket()
        for op in OPS:
            for _ in range(100):
                launch[op]()
        torch.cuda.synchronize()
        bracket()
    return collections.Counter(block_of(e.name) for e in prof.events()
                               if e.device_type == DeviceType.CUDA)


def probe(label: str, sessions: int, n_markers: int, wait: float) -> None:
    x = torch.full((4096,), 2.0, device="cuda")
    for way, settle, markers in (("bare", 0.0, 0),
                                 ("markers", 0.0, n_markers),
                                 ("wait+markers", wait, n_markers)):
        full, short = 0, []
        for _ in range(sessions):
            c = session(x, settle, markers)
            if all(c.get(op, 0) == 100 for op in OPS):
                full += 1
            else:
                short.append([c.get(op, 0) for op in OPS]
                             + [c.get("marker", 0)])
        print(f"{label}, {way}: {full} of {sessions} sessions kept all 800 "
              f"records; short sessions (per block {'/'.join(OPS)}, then "
              f"markers seen of {2 * markers}): {short}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_record_loss: needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    chip_smoke.setup()
    print(f"{torch.cuda.get_device_name(0)}, torch {torch.__version__}")
    bracket = (chip_smoke.MARKERS, chip_smoke.PROFILER_SETTLE_S)
    probe("fresh process", args.sessions, *bracket)
    chip_smoke.build_phase()
    chip_smoke.kernels_phase()
    probe("after phase 3", args.sessions, *bracket)
    return 0


if __name__ == "__main__":
    sys.exit(main())
