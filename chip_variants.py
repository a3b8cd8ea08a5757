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
  1  prefill (the Hopper step): what bounds it: copies only (no compute),
     compute only (no TMA copies), 64-row tiles everywhere (one consumer
     warpgroup), 128-row tiles wherever there are 128 rows (whatever the
     head dim and walk), one stage after the other (no overlap);
  2  prefill: paged prefill without key partitions, flash's tiles in
     order instead of the longest walks first, two CTAs an SM where three
     fit (flash at hd 32 and 64);
  3  decode (ring and paged): partitions of 32 and 128 slots against 64,
     copies only (no scores, no P V), compute only (no copies), the
     partition kernel without the merge kernel, a merge whose loop has
     no branch, the shared-memory carveout at its maximum, and paged
     decode reading its table beside ``pos``; v0 and SDPA are also timed
     with an L2 flush that reads instead of writes (``clean_flush_us``),
     and v0's kernels one by one under the profiler (``v0_kernels_us``);
  5  paged prefill's key partitions: the library's rule (v0) against no
     split, 2, 4 and 8 parts whatever the grid (``("SPLIT", n)``: the
     wrapper's ``partitions`` replaced), at phase 3's paged shapes and at
     block sizes 4 and 12 (no TMA box fits their pieces); then phases 9
     and 11 (RecurrentGemma-9B, Nemotron-4-340B) end to end under v0 and
     S1, each printed as one JSON line of its prefill breakdown;
  6  the one-launch SGMV and ring decode kernels (bf16) against the
     parent commit's kernels and wrappers (v0: the tree at that commit,
     unpacked under ``build/parent/`` before the call: ``git archive
     <parent> src/repro_torch | tar -x -C build/parent``) against this tree's
     (``new``) at every bf16 phase-3 case of the two kernels and of paged
     decode (whose sources did not change: its times should stay), plus
     the design's choices one at a time: SGMV's cluster of 4, 8 or 16
     whatever the rows, column tiles of the least power of two over the
     CTAs instead of the balanced rule, half or twice the copies over O,
     two ring stages, a 160 KB ring, and, to see where the time goes, the
     shrink's products or the expand left out; ring decode's cluster rule
     at two or four times the CTAs (one CTA an SM at most by the rule), 2
     or 4 stages instead of 3, partitions of 16 KB, and the consumers'
     compute or the producer's copies left out.  SGMV variants run on the
     SGMV cases, ring variants on the ring cases.  Only sgmv.cu, paged_attn.cu
     and decode_attn.cu are built, each library in parallel;
  7  the one-launch bf16 paged decode kernel against the parent commit's
     split-KV kernel and merge (v0: the parent's tree under
     ``build/parent/`` as for set 6, its own wrappers and library) at every
     phase-3 paged decode case, bf16 and float32 (whose kernels did not
     change: its times should stay), and at every bf16 ring decode case
     (whose step is now shared: its times should stay too), plus the
     cluster rule's alternatives on the bf16 paged cases: clusters of 1,
     2, 4 and 8 whatever the grid, and the rule at twice the CTAs (up to
     two CTAs an SM); ring decode's chunk-major layout at hd 128 and 192
     (a TMA box a 64-column chunk, not one a piece), stages of half the
     slots (twice as many of them), the producer resolving a stage's table
     entries only once its ring slot is free (not before its wait), and, to
     see where the time goes, the consumers' compute or the producer's
     copies left out.  The cases are made from phase 3's draws (every
     phase-3 case made once first), so their inputs are phase 3's.  v0's and the new kernels' device time by kind
     under the profiler (``kernels_us``: partitions and merge apart) is
     printed for the bf16 paged cases.  Only paged_attn.cu and
     decode_attn.cu are built.
The "copies only", "compute only", "no merge", "no compute", "no copy"
and "no expand" variants give wrong outputs by design; their errors are
printed, not checked.
"""
from __future__ import annotations

import ctypes
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

import chip_smoke as cs

# paged decode's cluster rule (csrc/paged_attn.cu::paged_plan)
PAGED_RULE = """  while (p.cluster < kMaxCluster && units * p.cluster * 2 <= kSms &&
         2 * p.cluster <= np)
    p.cluster *= 2;"""

SETS = {
    "1": ("prefill", {
        "v0": [],
        "nocompute": [("prefill_tile.cuh",
                       "  while (ja <= jb && skip(ja)) ++ja;",
                       "  ja = jb + 1;")],
        "nocopy": [
            ("flash_attn.cu",
             "        rt::mbar_arrive_tx(&sm.full[slot], 2 * C::kTileBytes);\n",
             "        rt::mbar_arrive(&sm.full[slot]);\n        return;\n"),
            ("paged_prefill.cu", "__popc(read) * 2 * Cf::NCH * R * Cf::SWB",
             "0"),
            ("paged_prefill.cu", "        if (phys >= 0) {\n"
             "          const int row", "        if (false) {\n"
             "          const int row")],
        "tile64": [("prefill_tile.cuh", "  return rows >= 128 && (hd > 128 "
                    "|| (hd == 128 && walk >= 512)) ? 128 : 64;",
                    "  return 64;")],
        "tile128": [("prefill_tile.cuh", "  return rows >= 128 && (hd > 128 "
                     "|| (hd == 128 && walk >= 512)) ? 128 : 64;",
                     "  return rows >= 128 ? 128 : 64;")],
        "serial": [("prefill_tile.cuh", "  if (C::NS < 3 && ja <= jb) {",
                    "  if (ja <= jb) {")],
    }),
    "2": ("prefill", {
        "v0": [],
        "paged-no-split": [("paged_prefill.cu",
                            "  using Cf = CfgBf16<HD, NWG>;\n  // a stage",
                            "  using Cf = CfgBf16<HD, NWG>;\n  S = 1;\n"
                            "  // a stage")],
        "flash-in-order": [("flash_attn.cu",
                            "const int r0 = (gridDim.x - 1 - blockIdx.x) * "
                            "C::kM;", "const int r0 = blockIdx.x * C::kM;")],
        "occ2": [("prefill_tile.cuh", "constexpr int kMaxOcc = KPOS ? 2 : 3;",
                  "constexpr int kMaxOcc = 2;")],
    }),
    "5": ("paged", {
        "v0": [],
        "S1": [("SPLIT", 1)],
        "S2": [("SPLIT", 2)],
        "S4": [("SPLIT", 4)],
        "S8": [("SPLIT", 8)],
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
    "6": ("redesign", {
        "v0": [("PARENT", True)],
        "new": [],
        "sgmv-c4": [("sgmv.cu", "  Plan p{tiles <= 4 && (tiles == 1 || chunks "
                     ">= 64) ? 16", "  Plan p{true ? 4")],
        "sgmv-c8": [("sgmv.cu", "  Plan p{tiles <= 4 && (tiles == 1 || chunks "
                     ">= 64) ? 16", "  Plan p{true ? 8")],
        "sgmv-c16": [("sgmv.cu", "  Plan p{tiles <= 4 && (tiles == 1 || chunks "
                      ">= 64) ? 16", "  Plan p{true ? 16")],
        "sgmv-cols-pow2": [("sgmv.cu", "    if (best == 0 || cost < best) {",
                            "    if (best == 0 || cols * ctas >= O) {")],
        "sgmv-os-half": [("sgmv.cu", "constexpr int kTargetCtas = 128;",
                          "constexpr int kTargetCtas = 64;")],
        "sgmv-os-double": [("sgmv.cu", "constexpr int kTargetCtas = 128;",
                            "constexpr int kTargetCtas = 256;")],
        "sgmv-stages-2": [("sgmv.cu", "  const int ns = min(kMaxStages, "
                           "kRingBytes / sb);", "  const int ns = 2;")],
        "sgmv-ring-160k": [("sgmv.cu", "constexpr int kRingBytes = 96 * 1024;",
                            "constexpr int kRingBytes = 160 * 1024;")],
        "sgmv-no-compute": [("sgmv.cu", "      if (live) {\n        const "
                             "unsigned char* Xs", "      if (false) {\n"
                             "        const unsigned char* Xs")],
        "sgmv-no-expand": [("sgmv.cu", "  if (warp < kCWarps) {\n    const "
                            "int ncg", "  if (false) {\n    const int ncg")],
        "ring-c-double": [("ring_decode_step.cuh",
                           "units * p.cluster * 2 <= kSms",
                           "units * p.cluster <= kSms")],
        "ring-c-quad": [("ring_decode_step.cuh",
                         "units * p.cluster * 2 <= kSms",
                         "units * p.cluster <= 2 * kSms")],
        "ring-stages-4": [("ring_decode_step.cuh",
                           "  Plan p{1, part_for(hd), 3};",
                           "  Plan p{1, part_for(hd), 4};")],
        "ring-stages-2": [("ring_decode_step.cuh",
                           "  Plan p{1, part_for(hd), 3};",
                           "  Plan p{1, part_for(hd), 2};")],
        "ring-part-half": [("ring_decode_step.cuh",
                            "constexpr int kStageBytes = 32 * 1024;",
                            "constexpr int kStageBytes = 16 * 1024;")],
        "ring-no-compute": [("ring_decode_step.cuh",
                             "        if (gb == 0) continue;",
                             "        if (gb == 0 || gb != 0) continue;")],
        "ring-no-copy": [("ring_decode_step.cuh",
                          "        mbar_arrive_tx(&full[s], sb);\n#pragma "
                          "unroll\n        for (int x = 0; x < X::kCount;",
                          "        mbar_arrive(&full[s]);\n#pragma unroll\n"
                          "        for (int x = 0; x < 0;")],
    }),
    "7": ("redesign", {
        "v0": [("PARENT", True)],
        "new": [],
        **{f"paged-c{c}": [("paged_attn.cu", PAGED_RULE,
                            f"  p.cluster = {c};")] for c in (1, 2, 4, 8)},
        "paged-c-double": [("paged_attn.cu", PAGED_RULE, PAGED_RULE.replace(
            "units * p.cluster * 2 <= kSms", "units * p.cluster <= kSms"))],
        "paged-chunk-major": [("paged_attn.cu", "static constexpr bool "
                               "kRowMajor = X::kCount == 2 || X::kCount == 3;",
                               "static constexpr bool kRowMajor = false;")],
        "paged-stage-16k": [("paged_attn.cu",
                             "(hd > 128 ? 2 : 1) * kStageBytes)",
                             "(hd > 128 ? 2 : 1) * kStageBytes / 2)")],
        "paged-prepare-after-wait": [
            ("ring_decode_step.cuh", "      ps.prepare(j, lane);\n      if "
             "(k >= ns) mbar_wait(&empty[s], ((k / ns) - 1) & 1);\n",
             "      if (k >= ns) mbar_wait(&empty[s], ((k / ns) - 1) & 1);\n"
             "      ps.prepare(j, lane);\n")],
        "paged-no-compute": [("ring_decode_step.cuh",
                              "        if (gb == 0) continue;",
                              "        if (gb == 0 || gb != 0) continue;")],
        "paged-no-copy": [
            ("paged_attn.cu", "mbar_arrive_tx(full, read * 4 * R * HD);",
             "mbar_arrive_tx(full, 0);"),
            ("paged_attn.cu", "      if (prow[q] < 0) continue;",
             "      if (prow[q] < 0 || prow[q] >= 0) continue;")],
    }),
}


def applies(variant: str, case: str) -> bool:
    """Set 6's and 7's variants named for one kernel run on that kernel's
    bf16 cases."""
    for prefix in ("sgmv", "ring", "paged"):
        if variant.startswith(prefix + "-"):
            return case.startswith(prefix + " ") and "f32" not in case
    return True


def redesign_cases(gen, names: dict, dtypes, same_draws: bool = False
                   ) -> dict:
    """The phase-3 cases of the kernels in ``names`` (phase 3's name ->
    short name) in ``dtypes``, named short name (+ " f32") + index.  With
    ``same_draws`` each case is made from the generator state phase 3
    makes it from (every case of phase 3 made once, in order, first), so
    its inputs are phase 3's."""
    makers, _, shared = cs.phase3_makers(gen)
    out, seen = {}, {}
    for name, dtype, make in makers:
        keep = name in names and dtype in dtypes
        if keep:
            key = names[name] + (" f32" if dtype == torch.float32 else "")
            i = seen[key] = seen.get(key, 0) + 1
            if same_draws:
                state = gen.get_state()
                make = (lambda m=make, st=state: (gen.set_state(st), m())[1])
            out[f"{key} {i}"] = make
        if same_draws:
            make()                  # advance the generator as phase 3 does
            torch.cuda.empty_cache()
    shared.clear()
    return out


def setting(patches, key: str):
    """The value a variant gives ``key`` ("PARTITION", "SGMV", "SPLIT"),
    if any."""
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


REDESIGN_SOURCES = {"6": ("sgmv.cu", "paged_attn.cu", "decode_attn.cu"),
                    "7": ("paged_attn.cu", "decode_attn.cu")}
PARENT = Path("build/parent/src/repro_torch")


def _load(name: str, path: Path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _build_lib(csrc: Path, out: Path, signatures, sources) -> ctypes.CDLL:
    """``sources`` of ``csrc`` compiled (one nvcc each, in parallel) and
    linked into ``out``, loaded with ``signatures``' argument types; every
    registers / spills line of the build printed."""
    from repro_torch.kernels import cuda_lib
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    nvcc = cuda_lib.nvcc_path()
    objs = [out / (Path(src).stem + ".o") for src in sources]
    procs = [subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, "-c",
                               str(csrc / src), "-o", str(obj)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        cs.fail(f"nvcc failed in {csrc}:\n" + "\n".join(logs))
    lib_path = out / "lib.so"
    subprocess.run([nvcc, "-shared", *map(str, objs), "-o", str(lib_path)],
                   check=True)
    for u in cs.ptxas_usage("\n".join(logs)):
        if ("sgmv_bf16" in u["function"] or "_decode_kernelILi" in
                u["function"] or u.get("spill_stores")):
            print(f"{out.name}: {u['function'][:70]}... {u['registers']} "
                  f"registers, spill stores {u.get('spill_stores')} B",
                  flush=True)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in signatures.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    return lib


def build_redesign(variants, sources):
    """Sets 6 and 7: the parent's library (its sources, its signatures)
    and every variant's, built in parallel; the parent's SGMV, ring decode
    and paged decode wrappers loaded over its own library.  Returns (libs,
    parent wrappers)."""
    from repro_torch.kernels import cuda_lib
    if not (PARENT / "csrc" / "sgmv.cu").exists():
        cs.fail(f"set 6 needs the parent's tree under {PARENT}")
    root = cuda_lib.BUILD_ROOT.parent / "variants"
    plib = _load("parent_cuda_lib", PARENT / "kernels" / "cuda_lib.py")
    jobs = {}
    for name, patches in variants.items():
        if setting(patches, "PARENT"):
            jobs[name] = (PARENT / "csrc", plib._SIGNATURES)
            continue
        d = root / name / "csrc"
        shutil.rmtree(d.parent, ignore_errors=True)
        shutil.copytree(cuda_lib.CSRC, d)
        for f, old, new in patches:
            src = (d / f).read_text()
            if old not in src:
                cs.fail(f"variant {name}: {f} has no line {old!r}")
            (d / f).write_text(src.replace(old, new))
        jobs[name] = (d, cuda_lib._SIGNATURES)
    with ThreadPoolExecutor(len(jobs)) as ex:
        futs = {n: ex.submit(_build_lib, d, root / n / "build", sig,
                             sources)
                for n, (d, sig) in jobs.items()}
        libs = {n: f.result() for n, f in futs.items()}
    plib.library = lambda: libs["v0"]
    wrappers = {}
    for key, rel in (("sgmv", "sgmv/ops.py"),
                     ("ring", "decode_attention/ops.py"),
                     ("paged", "paged_attention/ops.py")):
        mod = _load(f"parent_{key}_ops", PARENT / "kernels" / rel)
        mod.cuda_lib = plib
        wrappers[key] = mod
    return libs, wrappers


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
                if (u.get("spill_stores") or "_bf16ILi128" in u["function"] or
                        "_decode_part_kernelI13__nv_bfloat16Li128ELi1E"
                        in u["function"] or "sgmv_" in u["function"]):
                    print(f"{name}: {u['function'][:60]}... "
                          f"{u['registers']} registers, spill stores "
                          f"{u.get('spill_stores')} B", flush=True)
            for ln in info.log.splitlines():
                if "warning" in ln and "wgmma" in ln:   # a serialised wgmma
                    print(f"{name}: {ln.strip()[:200]}", flush=True)
            built[sources] = libs[name] = cuda_lib.library()
    finally:
        cuda_lib.CSRC, cuda_lib.BUILD_ROOT = base, build_root
        cuda_lib.library.cache_clear()
    return libs


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else "1"
    kind, variants = SETS[which]
    device = cs.device_phase()
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.decode_attention import ops as ring_ops
    from repro_torch.kernels.paged_attention import ops as paged_ops
    from repro_torch.kernels.paged_prefill import ops as pp_ops
    from repro_torch.kernels.sgmv import ops as sgmv_ops
    parent = None
    if kind == "redesign":
        libs, parent = build_redesign(variants, REDESIGN_SOURCES[which])
    else:
        libs = build_variants(variants)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    bf, T, Bl = torch.bfloat16, cs.LAUNCH["prompt_len"], cs.LAUNCH_BATCH
    S, last = cs.LAUNCH_CONTEXT, T + cs.LAUNCH["max_new"] - 2
    rg, nm = get_config(cs.RGEMMA), get_config(cs.NEMOTRON)
    rgs, nms, nhi = cs.RGEMMA_SERVE, cs.NEMOTRON_SERVE, cs.NEMOTRON_PROMPT[1]
    paged = {
        "paged": lambda: cs.prefill_case(gen, bf),
        "paged GQA": lambda: cs.prefill_case(gen, bf, K=8, G=4),
        "paged window 128": lambda: cs.prefill_case(gen, bf, window=128),
        "paged G 6 window 4096": lambda: cs.prefill_case(
            gen, bf, K=8, G=6, window=4096, serve=cs.MIXTRAL_SERVE,
            starts=(4096, cs.MIXTRAL_PROMPT[1]
                    - cs.MIXTRAL_SERVE["prefill_chunk"])),
        "paged RG-9B": lambda: cs.prefill_case(
            gen, bf, K=rg.num_kv_heads, G=rg.num_heads // rg.num_kv_heads,
            hd=rg.head_dim_, window=rg.sliding_window, serve=rgs,
            starts=(rg.sliding_window,
                    cs.RGEMMA_PROMPT[1] - rgs["prefill_chunk"]), parts=4),
        "paged Nemotron": lambda: cs.prefill_case(
            gen, bf, K=nm.num_kv_heads, G=nm.num_heads // nm.num_kv_heads,
            hd=nm.head_dim_, serve=nms,
            starts=(nhi - 2 * nms["prefill_chunk"],
                    nhi - nms["prefill_chunk"])),
    }
    cases = {
        "prefill": {
            "flash B=3": lambda: cs.flash_case(gen, bf, Bl, T, 32, 1),
            "flash B=8": lambda: cs.flash_case(gen, bf, 8, T, 32, 1),
            "flash GQA": lambda: cs.flash_case(gen, bf, Bl, T, 8, 4),
            "flash window 128": lambda: cs.flash_case(gen, bf, Bl, T, 32, 1,
                                                      window=128),
            "flash SmolLM 8 x 256": lambda: cs.flash_case(
                gen, bf, cs.ZOO_ROWS, cs.ZOO_PROMPT, 5, 3, hd=64),
            "flash prefix 100 window 40": lambda: cs.flash_case(
                gen, bf, 2, 150, 2, 4, window=40, prefix=100),
            "flash hd 192 G 12": lambda: cs.flash_case(
                gen, bf, cs.RING_ROWS, 512, 8, 12, hd=192),
            "flash Whisper encoder": lambda: cs.flash_case(
                gen, bf, cs.WHISPER_ROWS, 1500, 16, 1, hd=64, causal=False),
            "flash 1 x 32768": lambda: cs.flash_case(
                gen, bf, cs.SHARDED_PREFILL_ROWS, cs.SHARDED_CONTEXT, 32, 1),
            **paged,
        },
        "paged": {
            **paged,
            "paged bs 4": lambda: cs.prefill_case(
                gen, bf, serve=cs.SMALL_BLOCK_SERVE[4]),
            "paged bs 12 GQA": lambda: cs.prefill_case(
                gen, bf, K=8, G=4, serve=cs.SMALL_BLOCK_SERVE[12]),
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
        "redesign": redesign_cases(
            gen, {"sgmv": "sgmv", "decode_attention": "ring",
                  "paged_attention": "paged"}, (torch.bfloat16,))
        if which == "6" else redesign_cases(
            gen, {"decode_attention": "ring", "paged_attention": "paged"},
            (torch.bfloat16, torch.float32), same_draws=True),
    }[kind]
    order = list(variants) + list(reversed(variants))
    # every line also goes to a file (the card's tool keeps only the end of
    # the output)
    out = Path("chiprun_out") / f"variants_{which}.jsonl"
    out.parent.mkdir(exist_ok=True)
    out.write_text("")
    real, part = cuda_lib.library, ring_ops.PARTITION
    real_sgmv, real_ring = sgmv_ops.sgmv_apply, ring_ops.decode_gqa
    real_paged = paged_ops.paged_decode_gqa
    split_rule = pp_ops.partitions
    sgmv_names = {name: getattr(sgmv_ops, name)
                  for v in variants.values()
                  for name in (setting(v, "SGMV") or {})}

    def use(n: str) -> None:
        cuda_lib.library = lambda: libs[n]
        if parent is not None:   # sets 6, 7: v0 is the parent's wrappers
            v0 = setting(variants[n], "PARENT")
            sgmv_ops.sgmv_apply = (parent["sgmv"].sgmv_apply if v0
                                   else real_sgmv)
            ring_ops.decode_gqa = (parent["ring"].decode_gqa if v0
                                   else real_ring)
            paged_ops.paged_decode_gqa = (parent["paged"].paged_decode_gqa
                                          if v0 else real_paged)
        ring_ops.PARTITION = paged_ops.PARTITION = \
            setting(variants[n], "PARTITION") or part
        for name, value in {**sgmv_names,
                            **(setting(variants[n], "SGMV") or {})}.items():
            setattr(sgmv_ops, name, value)
        split = setting(variants[n], "SPLIT")
        pp_ops.partitions = (lambda *a, S=split: S) if split else split_rule

    try:
        for cname, make in cases.items():
            use("v0")           # a case is made under the library's rules
            c = make()
            want = c["plain"]()
            mine = [n for n in variants if applies(n, cname)]
            us = {n: [] for n in mine}
            err = {}
            for n in (x for x in order if x in mine):
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
            if kind == "redesign" and (
                    not cname.startswith("paged") if which == "6"
                    else cname.startswith("paged ") and "f32" not in cname):
                line["kernels_us"] = {}
                for n in ("v0", "new"):
                    use(n)
                    line["kernels_us"][n] = kernel_split(c["kernel"], flush)
            print(json.dumps(line), flush=True)
            with out.open("a") as f:
                f.write(json.dumps(line) + "\n")
        if kind == "paged":
            for label, run in (("phase 9", cs.recurrentgemma_phase),
                               ("phase 11", cs.nemotron_phase)):
                for n in ("v0", "S1"):
                    use(n)
                    out = run(device)
                    pre = out["breakdown"]["prefill_admission"]
                    print(json.dumps({
                        "e2e": label, "variant": n,
                        "ttft_p50_s": out.get("ttft_p50_s"),
                        "dispatches": pre["dispatches"],
                        "prefill_wall_ms": pre["wall_ms"],
                        "prefill_device_busy_ms": pre["device_busy_ms"],
                        "device_ms_by_kind": pre["device_ms_by_kind"]}),
                        flush=True)
    finally:
        cuda_lib.library = real
        sgmv_ops.sgmv_apply, ring_ops.decode_gqa = real_sgmv, real_ring
        paged_ops.paged_decode_gqa = real_paged
        ring_ops.PARTITION = paged_ops.PARTITION = part
        pp_ops.partitions = split_rule
        for name, value in sgmv_names.items():
            setattr(sgmv_ops, name, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
