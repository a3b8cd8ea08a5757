#!/usr/bin/env python3
"""Time patched variants of the bf16 prefill kernels on one Hopper card.

    python3 chip_variants.py [SET]

Run it from the root of a checkout, on the machine with the card.  Each
variant of a set is a copy of ``src/repro_torch/csrc`` with a few source
lines replaced; it is built with the port's own build (``cuda_lib.build``)
into ``build/variants/<name>/`` and loaded beside the others.  Then each
case of ``chip_smoke.py``'s phase 3 (flash and paged prefill, bf16, at the
serving shapes) is timed with every variant in turns (v0 first and last),
L2 flushed before each call, and printed as one JSON line: median µs per
variant, its error against the plain version, SDPA's time and the bound.

Sets:
  1  what bounds the step: copies only (no compute), compute only (no
     copies), one more ring stage, three CTAs per SM for flash;
  2  ring depth of paged prefill, order of flash's tiles.
The "copies only" and "compute only" variants give wrong outputs by
design; their errors are printed, not checked.
"""
from __future__ import annotations

import json
import shutil
import sys

import torch

import chip_smoke as cs

SETS = {
    "1": {
        "v0": [],
        "ns+1": [("flash_attn.cu", "constexpr int kStagesBf16 = 2;",
                  "constexpr int kStagesBf16 = 3;"),
                 ("paged_prefill.cu", "constexpr int kStagesBf16 = 3;",
                  "constexpr int kStagesBf16 = 4;")],
        "flash3cta": [("flash_attn.cu",
                       "__launch_bounds__(rt::tile::tc::kThreads, 2)",
                       "__launch_bounds__(rt::tile::tc::kThreads, 3)")],
        "nocompute": [("prefill_tile.cuh", "    stage(s, s % NS);\n", "")],
        "nocopy": [("prefill_tile.cuh", "    if (s < n) issue(s, s);\n", ""),
                   ("prefill_tile.cuh",
                    "    if (s + NS - 1 < n) issue(s + NS - 1, "
                    "(s + NS - 1) % NS);\n", "")],
    },
    "2": {
        "v0": [],
        "paged-ns2": [("paged_prefill.cu", "constexpr int kStagesBf16 = 3;",
                       "constexpr int kStagesBf16 = 2;")],
        "flash-in-order": [("flash_attn.cu",
                            "const int r0 = (gridDim.y - 1 - blockIdx.y) "
                            "* kM;", "const int r0 = blockIdx.y * kM;")],
    },
}


def build_variants(variants):
    from repro_torch.kernels import cuda_lib
    base, build_root = cuda_lib.CSRC, cuda_lib.BUILD_ROOT
    root = build_root.parent / "variants"
    libs = {}
    try:
        for name, patches in variants.items():
            d = root / name
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(base, d / "csrc")
            for f, old, new in patches:
                p = d / "csrc" / f
                src = p.read_text()
                if old not in src:
                    cs.fail(f"variant {name}: {f} has no line {old!r}")
                p.write_text(src.replace(old, new))
            cuda_lib.CSRC, cuda_lib.BUILD_ROOT = d / "csrc", d / "build"
            cuda_lib.library.cache_clear()
            info = cuda_lib.build()
            for u in cs.ptxas_usage(info.log):
                if "_bf16ILi128" in u["function"]:
                    print(f"{name}: {u['function'][:60]}... "
                          f"{u['registers']} registers, spill stores "
                          f"{u.get('spill_stores')} B", flush=True)
            libs[name] = cuda_lib.library()
    finally:
        cuda_lib.CSRC, cuda_lib.BUILD_ROOT = base, build_root
        cuda_lib.library.cache_clear()
    return libs


def main() -> int:
    variants = SETS[sys.argv[1] if len(sys.argv) > 1 else "1"]
    cs.device_phase()
    from repro_torch.kernels import cuda_lib
    libs = build_variants(variants)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    bf, T, Bl = torch.bfloat16, cs.LAUNCH["prompt_len"], cs.LAUNCH_BATCH
    cases = {
        "flash B=3": lambda: cs.flash_case(gen, bf, Bl, T, 32, 1),
        "flash B=8": lambda: cs.flash_case(gen, bf, 8, T, 32, 1),
        "flash GQA": lambda: cs.flash_case(gen, bf, Bl, T, 8, 4),
        "paged": lambda: cs.prefill_case(gen, bf),
        "paged GQA": lambda: cs.prefill_case(gen, bf, K=8, G=4),
    }
    order = list(variants) + list(reversed(variants))
    real = cuda_lib.library
    try:
        for cname, make in cases.items():
            c = make()
            want = c["plain"]()
            us = {n: [] for n in variants}
            err = {}
            for n in order:
                cuda_lib.library = lambda n=n: libs[n]
                got = c["kernel"]()
                torch.cuda.synchronize()
                err[n] = float((got.float() - want.float()).abs().max())
                us[n].append(cs.device_ms(c["kernel"], 30, flush) * 1e3)
            print(json.dumps({
                "case": cname, "shape": c["shape"],
                "bound_us": c["bound_ms"] * 1e3,
                "sdpa_us": cs.device_ms(c["library"], 30, flush) * 1e3,
                "us": us, "err": err}), flush=True)
    finally:
        cuda_lib.library = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
