#!/usr/bin/env python3
"""Which ops of a dry run make a device do more than its share.

    PYTHONPATH=src python tools/dryrun_op_share.py llama2_7b train_4k \\
        [--multi-pod] [--optimized] [--layers N]

Runs ``launch/dryrun.py::run_one`` (meta tensors as DTensors over the fake
world of 256 or 512 ranks) with a recorder inside its FLOP counter.  For
every op on DTensors that has a FLOP formula it notes the global op's
FLOPs over the devices, the local op DTensor desugars it to, the inputs'
placements and the autograd node that ran it (``fwd`` outside the
backward).  It prints the step's per-device FLOPs beside the same step's
count on plain meta tensors over the devices (their ratio is 1 when no
device repeats another's work), the local products by FLOPs, and the ops
whose local work is above their share, by the excess.  ``--layers`` cuts
the depth (the full width stays).
"""
from __future__ import annotations

import argparse
import collections
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import get_config
from repro_torch.kernels import cuda_lib
from repro_torch.launch import dryrun, specs
from repro_torch.launch.sharding import BASELINE, OPTIMIZED


class Recorder(TorchDispatchMode):
    """("G", op, global FLOPs, (placements..., node)) for each DTensor op,
    ("L", op, local FLOPs, shapes) for each local op after it."""

    def __init__(self):
        super().__init__()
        self.events = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if any(issubclass(t, DTensor) for t in types):
            if packet in flop_registry:
                n = int(flop_registry[packet](*args, **kwargs, out_val=None))
                node = torch._C._current_autograd_node()
                pl = tuple((tuple(a.shape), str(a.placements))
                           for a in args if isinstance(a, DTensor))
                self.events.append((
                    "G", str(packet), n,
                    pl + ("fwd" if node is None else type(node).__name__,)))
            return NotImplemented
        out = func(*args, **kwargs)
        if packet in flop_registry and not any(
                issubclass(t, FakeTensor) for t in types):
            n = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.events.append(("L", str(packet), n, tuple(
                tuple(a.shape) for a in args if isinstance(a, torch.Tensor))))
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch")
    ap.add_argument("shape", choices=list(specs.INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--optimized", action="store_true")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.with_(num_layers=args.layers)
    t0 = time.perf_counter()

    step = specs.build_step(cfg, args.shape)
    with cuda_lib.record_work() as work, dryrun.StepCounter() as plain:
        step.fn(*step.args)
    unsharded = plain.flops + sum(w.flops for _, w in work)

    rec = Recorder()
    base = dryrun.StepCounter

    class Counter(base):                  # the recorder inside the count
        def __enter__(self):
            super().__enter__()
            rec.__enter__()
            return self

        def __exit__(self, *exc):
            rec.__exit__(*exc)
            return super().__exit__(*exc)

    dryrun.StepCounter = Counter
    try:
        r = dryrun.run_one(args.arch, args.shape, multi_pod=args.multi_pod,
                           opts=OPTIMIZED if args.optimized else BASELINE,
                           save=False, config=cfg)
    finally:
        dryrun.StepCounter = base
    n = r["n_devices"]
    print(dryrun.summary_line(r))
    print(f"torch {torch.__version__}: {r['cost']['flops']} FLOPs a device "
          f"x {n} = {r['cost']['flops'] * n / unsharded!r} x the plain "
          f"count {unsharded} ({time.perf_counter() - t0:.1f} s)")

    local, calls = collections.Counter(), collections.Counter()
    for kind, op, flops, what in rec.events:
        if kind == "L":
            local[(op, what)] += flops
            calls[(op, what)] += 1
    print("local ops by FLOPs:")
    for key, f in local.most_common(args.top):
        print(f"  {f:.4e} x{calls[key]} {key}")
    excess, count = collections.Counter(), collections.Counter()
    for i, (kind, op, flops, what) in enumerate(rec.events):
        if kind != "G" or flops <= 0:
            continue
        for k2, op2, f2, _ in rec.events[i + 1:i + 4]:
            if k2 == "G":
                break
            if op2 == op:
                share = f2 * n / flops
                if share > 1.0 + 1e-9:
                    excess[(op, what, round(share, 2))] += f2 - flops / n
                    count[(op, what, round(share, 2))] += 1
                break
    print("ops above their share (excess FLOPs a device):")
    for key, f in excess.most_common(args.top):
        print(f"  {f:.4e} x{count[key]} {key}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
