#!/usr/bin/env python3
"""Time patched variants of the bf16 attention kernels on one Hopper card.

    python3 chip_variants.py [SET]

Run it from the root of a checkout, on the machine with the card.  Each
variant of a set is a copy of ``src/repro_torch/csrc`` with a few source
lines replaced, and may also set the split-KV decode wrappers'
``PARTITION`` (a ``("PARTITION", n)`` entry); it is built with the port's
own build (``cuda_lib.build``) into ``build/variants/<name>/`` (variants
with the same sources share one build) and loaded beside the others.  Then
each case of ``chip_smoke.py``'s phase 3 that the set names (bf16, at the
serving shapes) is timed with every variant in turns (v0 first and last),
L2 flushed before each call, and printed as one JSON line: median µs per
variant, its error against the plain version, SDPA's time and the bound.

Sets:
  1  prefill: what bounds the step: copies only (no compute), compute only
     (no copies), one more ring stage, three CTAs per SM for flash;
  2  prefill: ring depth of paged prefill, order of flash's tiles;
  3  decode (ring and paged): partitions of 32 and 128 slots against 64,
     copies only (no scores, no P V), compute only (no copies), the
     partition kernel without the merge kernel, a merge whose loop has
     no branch, the shared-memory carveout at its maximum, and paged
     decode reading its table beside ``pos``; v0 and SDPA are also timed
     with an L2 flush that reads instead of writes (``clean_flush_us``),
     and v0's kernels one by one under the profiler (``v0_kernels_us``).
The "copies only", "compute only" and "no merge" variants give wrong
outputs by design; their errors are printed, not checked.
"""
from __future__ import annotations

import json
import shutil
import statistics
import sys
from typing import Optional

import torch

import chip_smoke as cs

SETS = {
    "1": ("prefill", {
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
    }),
    "2": ("prefill", {
        "v0": [],
        "paged-ns2": [("paged_prefill.cu", "constexpr int kStagesBf16 = 3;",
                       "constexpr int kStagesBf16 = 2;")],
        "flash-in-order": [("flash_attn.cu",
                            "const int r0 = (gridDim.y - 1 - blockIdx.y) "
                            "* kM;", "const int r0 = blockIdx.y * kM;")],
    }),
    "3": ("decode", {
        "v0": [],
        "part32": [("PARTITION", 32)],
        "part128": [("PARTITION", 128)],
        "copies-only": [
            ("decode_tile.cuh", "  score_rows<T, HD, GP>(Ks, off, qr, sc, G, "
             "n, part, scale);\n", ""),
            ("decode_tile.cuh", "  pv_rows<T, HD, GP>(Vs, sc, acc, G, n, "
             "part);\n", "")],
        "compute-only": [
            ("decode_tile.cuh", "  copy_rows<T, HD>(Ks, k, off, n);\n", ""),
            ("decode_tile.cuh", "  copy_rows<T, HD>(Vs, v, off, n);\n", "")],
        "no-merge": [(f, "  if (cudaPeekAtLastError() != cudaSuccess) "
                      "return 0;  // launch_status\n", "  return 0;\n")
                     for f in ("decode_attn.cu", "paged_attn.cu")],
        "carveout-max": [("common.cuh", """  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));""", """  cudaFuncSetAttribute(kernel,
                       cudaFuncAttributePreferredSharedMemoryCarveout,
                       cudaSharedmemCarveoutMaxShared);
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));""")],
        "paged-tbl-beside-pos": [("paged_attn.cu", """  const int p = pos[b];
  const int t_end = min(min((s + 1) * part, p + 1), MB * bs);  // exclusive
  int t_begin = s * part;
  if (window > 0) t_begin = max(t_begin, p - window + 1);
  dec::partition_step<T, HD, GP>(
      q, kp, vp, static_cast<size_t>(b) * K + h, G, t_end - t_begin, part,
      [=](int i) -> long long {
        const int t = t_begin + i;
        const int phys = tbl[b * MB + t / bs];
        assert(phys < NB);
        return phys < 0""", """  const int t0 = s * part;
  dec::partition_step<T, HD, GP>(
      q, kp, vp, static_cast<size_t>(b) * K + h, G, min(part, MB * bs - t0),
      part,
      [=](int i) -> long long {
        const int t = t0 + i;
        const int phys = tbl[b * MB + t / bs];
        const int p = pos[b];
        assert(phys < NB);
        return phys < 0 || t > p || (window > 0 && t <= p - window)""")],
        "merge-unrolled": [("common.cuh", """      for (int s = 0; s < S; ++s) {
        const float ms = m[row * S + s];
        if (ms == neg_inf()) continue;
        const float w = expf(ms - mx);""", """#pragma unroll 4
      for (int s = 0; s < S; ++s) {
        const float ms = m[row * S + s];
        const float w = ms == neg_inf() ? 0.f : expf(ms - mx);""")],
    }),
}


def partition(patches) -> Optional[int]:
    """The decode wrappers' PARTITION a variant sets, if any."""
    return next((p[1] for p in patches if p[0] == "PARTITION"), None)


def kernel_split(fn, flush: torch.Tensor, runs: int = 5) -> dict:
    """Device time (µs) of each kernel kind in one call of ``fn`` after
    the same L2 flush and sleep as ``chip_smoke.device_ms``, from
    ``torch.profiler`` (kernel durations only, no launch gaps); median of
    ``runs`` calls."""
    def call():
        flush.zero_()
        torch.cuda._sleep(cs.SLEEP_CYCLES)
        fn()

    times = {}
    for _ in range(runs):
        by_kind = cs.profiled(call)["device_ms_by_kind"] or {}
        for kind, ms in by_kind.items():
            if kind != "other":          # the flush and the sleep
                times.setdefault(kind, []).append(ms * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def build_variants(variants):
    from repro_torch.kernels import cuda_lib
    base, build_root = cuda_lib.CSRC, cuda_lib.BUILD_ROOT
    root = build_root.parent / "variants"
    libs, built = {}, {}
    try:
        for name, patches in variants.items():
            sources = tuple(p for p in patches if len(p) == 3)
            if sources in built:
                libs[name] = built[sources]
                continue
            d = root / name
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(base, d / "csrc")
            for f, old, new in sources:
                p = d / "csrc" / f
                src = p.read_text()
                if old not in src:
                    cs.fail(f"variant {name}: {f} has no line {old!r}")
                p.write_text(src.replace(old, new))
            cuda_lib.CSRC, cuda_lib.BUILD_ROOT = d / "csrc", d / "build"
            cuda_lib.library.cache_clear()
            info = cuda_lib.build()
            for u in cs.ptxas_usage(info.log):
                if ("_bf16ILi128" in u["function"] or
                        "_decode_part_kernelI13__nv_bfloat16Li128ELi1E"
                        in u["function"]):
                    print(f"{name}: {u['function'][:60]}... "
                          f"{u['registers']} registers, spill stores "
                          f"{u.get('spill_stores')} B", flush=True)
            built[sources] = libs[name] = cuda_lib.library()
    finally:
        cuda_lib.CSRC, cuda_lib.BUILD_ROOT = base, build_root
        cuda_lib.library.cache_clear()
    return libs


def main() -> int:
    kind, variants = SETS[sys.argv[1] if len(sys.argv) > 1 else "1"]
    cs.device_phase()
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.decode_attention import ops as ring_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    libs = build_variants(variants)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    bf, T, Bl = torch.bfloat16, cs.LAUNCH["prompt_len"], cs.LAUNCH_BATCH
    S, last = cs.LAUNCH_CONTEXT, T + cs.LAUNCH["max_new"] - 2
    cases = {
        "prefill": {
            "flash B=3": lambda: cs.flash_case(gen, bf, Bl, T, 32, 1),
            "flash B=8": lambda: cs.flash_case(gen, bf, 8, T, 32, 1),
            "flash GQA": lambda: cs.flash_case(gen, bf, Bl, T, 8, 4),
            "paged": lambda: cs.prefill_case(gen, bf),
            "paged GQA": lambda: cs.prefill_case(gen, bf, K=8, G=4),
        },
        "decode": {
            "ring B=3": lambda: cs.ring_decode_case(gen, bf, Bl, S, 32, 1,
                                                    last),
            "ring B=8 wrapped": lambda: cs.ring_decode_case(
                gen, bf, 8, S, 32, 1, 2 * S + 17),
            "ring GQA": lambda: cs.ring_decode_case(gen, bf, Bl, S, 8, 4,
                                                    last),
            "paged": lambda: cs.decode_case(gen, bf),
            "paged GQA": lambda: cs.decode_case(gen, bf, K=8, G=4),
        },
    }[kind]
    order = list(variants) + list(reversed(variants))
    real, part = cuda_lib.library, ring_ops.PARTITION
    try:
        for cname, make in cases.items():
            c = make()
            want = c["plain"]()
            us = {n: [] for n in variants}
            err = {}
            for n in order:
                cuda_lib.library = lambda n=n: libs[n]
                ring_ops.PARTITION = paged_ops.PARTITION = \
                    partition(variants[n]) or part
                got = c["kernel"]()
                torch.cuda.synchronize()
                err[n] = float((got.float() - want.float()).abs().max())
                us[n].append(cs.device_ms(c["kernel"], 30, flush) * 1e3)
            line = {"case": cname, "shape": c["shape"],
                    "bound_us": c["bound_ms"] * 1e3,
                    "sdpa_us": cs.device_ms(c["library"], 30, flush) * 1e3,
                    "us": us, "err": err}
            if kind == "decode":
                cuda_lib.library = lambda: libs["v0"]
                ring_ops.PARTITION = paged_ops.PARTITION = part
                line["clean_flush_us"] = {
                    "v0": cs.device_ms(c["kernel"], 30, flush,
                                       read_flush=True) * 1e3,
                    "sdpa": cs.device_ms(c["library"], 30, flush,
                                         read_flush=True) * 1e3}
                line["v0_kernels_us"] = kernel_split(c["kernel"], flush)
            print(json.dumps(line), flush=True)
    finally:
        cuda_lib.library = real
        ring_ops.PARTITION = paged_ops.PARTITION = part
    return 0


if __name__ == "__main__":
    sys.exit(main())
