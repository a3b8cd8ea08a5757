#!/usr/bin/env python3
"""Time patched variants of the bf16 kernels on one Hopper card.

    python3 chip_variants.py [SET]

Run it from the root of a checkout, on the machine with the card.  Each
variant of a set is a copy of ``src/repro_torch/csrc`` with a few source
lines replaced, and may also set the split-KV decode wrappers'
``PARTITION`` (a ``("PARTITION", n)`` entry) or names of SGMV's wrapper
module ``sgmv/ops.py`` (a ``("SGMV", {name: value})`` entry: its rules and
the constants they read); it is built with the port's
own build (``cuda_lib.build``) into ``build/variants/<name>/`` (variants
with the same sources share one build) and loaded beside the others.  Then
each case of ``chip_smoke.py``'s phase 3 that the set names (bf16, at the
serving shapes) is timed with every variant in turns (v0 first and last),
L2 flushed before each call, and printed as one JSON line: median µs per
variant, its error against the plain version, the library yardstick's
time (SDPA for attention) and the bound.

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
     and v0's kernels one by one under the profiler (``v0_kernels_us``);
  4  SGMV (bf16) at the phase-3 row layouts and the warm-function decode
     batch: v0 is the first version's CUDA-core kernels (one CTA per row
     and 128-feature slice, then one thread per output column) against
     this version's row tiles, plus the new shrink only, the new expand
     only, the expand launched without programmatic dependence, the
     expand at four CTAs an SM instead of two, the slice
     rule at one shrink CTA an SM instead of four, a shrink ring of two
     stages, the expand without its L2 prefetch of B, the expand at 64
     rows a CTA whatever R, and where the new time goes: the shrink
     without its copies or without its cluster sum, the expand without its
     partials or without its FMAs; both versions' kernels one by one
     under the profiler (``kernels_us``).
The "copies only", "compute only", "no merge", "shrink only", "expand
only", "no copy", "no cluster sum", "no partials" and "no FMA" variants
give wrong outputs by design; their errors are printed, not checked.
"""
from __future__ import annotations

import json
import shutil
import statistics
import sys

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
    "4": ("sgmv", {
        "v0": [("sgmv.cu", "    return launch_tc(x, a, b, idx, part, y, R, D, "
                "r, O, N, dslice, erows,\n                     scaling, st);",
                "    launch_cuda_core<bf16>(x, a, b, idx, part, y, R, D, r, "
                "O, N, dslice, scaling, st);\n    return rt::launch_status();"),
               # the first version's slices of 128 and partials per slice
               ("SGMV", {"d_slice": lambda R, D: 128, "CLUSTER": 1})],
        "new": [],
        "shrink-only": [("sgmv.cu", "  cfg.numAttrs = 1;\n",
                         "  cfg.numAttrs = 1;\n  if (cfg.numAttrs) return "
                         "cudaSuccess;\n")],
        "expand-only": [("sgmv.cu", "  sgmv_shrink_tc_kernel<<<",
                         "  if (false) sgmv_shrink_tc_kernel<<<")],
        "no-pdl": [("sgmv.cu", "  cfg.numAttrs = 1;\n",
                    "  cfg.numAttrs = 0;\n")],
        "expand-rows-4-per-sm": [("SGMV", {"EXPAND_CTAS_PER_SM": 4})],
        "ctas-per-sm-1": [("SGMV", {"CTAS_PER_SM": 1})],
        "ring-2": [("sgmv.cu", "constexpr int kStages = 4;",
                    "constexpr int kStages = 2;")],
        "no-b-prefetch": [("sgmv.cu", "  if (first_ad >= 0 && col_ok)\n",
                           "  if (false)\n")],
        "shrink-no-copy": [
            ("sgmv.cu", "    if (j < n) issue(j, j);\n", ""),
            ("sgmv.cu", "      issue(j + kStages - 1, (j + kStages - 1) % "
             "kStages);\n", "      ;\n")],
        "shrink-no-cluster-sum": [
            ("sgmv.cu", "  cluster.sync();\n  {", "  {"),
            ("sgmv.cu", "    if (k < r && ids[row] >= 0) {",
             "    if (false) {"),
            ("sgmv.cu", "  cluster.sync();  // no CTA leaves while another "
             "reads its `red`\n", "")],
        "expand-no-partials": [
            ("sgmv.cu", "  for (int i = tid; i < nq; i += kThreads)\n"
             "    cp_async16(pt + 4 * i, src + 4 * i, true);\n", ""),
            ("sgmv.cu", "    for (int q = 0; q < sp; ++q) v += pt[(row * sp "
             "+ q) * RK + k];\n", "")],
        "expand-rows-64": [("SGMV", {"EXPAND_CTAS_PER_SM": 0})],
        "expand-no-fma": [("sgmv.cu", "          acc[c] = fmaf(xv[kk], bv[4 "
                           "* k4 + kk][c], acc[c]);",
                           "          acc[c] = bv[4 * k4 + kk][c];")],
    }),
}


def setting(patches, key: str):
    """The value a variant gives ``key`` ("PARTITION", "SGMV"), if
    any."""
    return next((p[1] for p in patches if p[0] == key), None)


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
                        in u["function"] or "sgmv_" in u["function"]):
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
    from repro_torch.kernels.sgmv import ops as sgmv_ops
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
        "sgmv": {
            "R=8 interleaved": lambda: cs.sgmv_case(gen, bf, 8),
            "R=256 interleaved": lambda: cs.sgmv_case(gen, bf, 256),
            "R=256 runs of 64": lambda: cs.sgmv_case(gen, bf, 256, run=64),
            "R=1500 one adapter": lambda: cs.sgmv_case(
                gen, bf, 1500, run=500, adapters=1),
            "R=3 one adapter": lambda: cs.sgmv_case(gen, bf, 3, run=3,
                                                    adapters=1),
        },
    }[kind]
    order = list(variants) + list(reversed(variants))
    real, part = cuda_lib.library, ring_ops.PARTITION
    sgmv_names = {name: getattr(sgmv_ops, name)
                  for v in variants.values()
                  for name in (setting(v, "SGMV") or {})}

    def use(n: str) -> None:
        cuda_lib.library = lambda: libs[n]
        ring_ops.PARTITION = paged_ops.PARTITION = \
            setting(variants[n], "PARTITION") or part
        for name, value in {**sgmv_names,
                            **(setting(variants[n], "SGMV") or {})}.items():
            setattr(sgmv_ops, name, value)

    try:
        for cname, make in cases.items():
            c = make()
            want = c["plain"]()
            us = {n: [] for n in variants}
            err = {}
            for n in order:
                use(n)
                got = c["kernel"]()
                torch.cuda.synchronize()
                err[n] = float((got.float() - want.float()).abs().max())
                us[n].append(cs.device_ms(c["kernel"], 30, flush) * 1e3)
            line = {"case": cname, "shape": c["shape"],
                    "bound_us": c["bound_ms"] * 1e3,
                    "library_us": (cs.device_ms(c["library"], 30, flush) *
                                   1e3 if c["library"] is not None
                                   else None),
                    "us": us, "err": err}
            if kind == "decode":
                use("v0")
                line["clean_flush_us"] = {
                    "v0": cs.device_ms(c["kernel"], 30, flush,
                                       read_flush=True) * 1e3,
                    "sdpa": cs.device_ms(c["library"], 30, flush,
                                         read_flush=True) * 1e3}
                line["v0_kernels_us"] = kernel_split(c["kernel"], flush)
            if kind == "sgmv":
                line["kernels_us"] = {}
                for n in ("v0", "new"):
                    use(n)
                    line["kernels_us"][n] = kernel_split(c["kernel"], flush)
            print(json.dumps(line), flush=True)
    finally:
        cuda_lib.library = real
        ring_ops.PARTITION = paged_ops.PARTITION = part
        for name, value in sgmv_names.items():
            setattr(sgmv_ops, name, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
