#!/usr/bin/env python3
"""Where a CTA of the bf16 paged decode kernel spends its cycles, on one
Hopper card.

    python3 tools/decode_step_clock.py [CASE ...]

Run from the root of a checkout.  Builds a copy of ``src/repro_torch/csrc``
under ``build/clock/`` whose decode step (``ring_decode_step.cuh``) stamps
``clock64()`` at each stage's turns: the producer warp after ``prepare``,
after its wait for the ring slot and after ``fill`` (its TMA copies
issued); consumer warp 0 once the stage has landed and once it has done its
groups; and the epilogue's start, its cluster barrier and its end.  Each
CTA of the cluster's first rank and every eighth (row, kv head) prints its
stamps (device ``printf``, in a child process whose output this script
reads).  A case (``llama``, ``nemotron``, ``mixtral``, ``rgemma``; all by
default) is one of phase 3's paged decode cases of ``chip_smoke.py`` (its
shapes; the inputs drawn from a generator of the case's own), called three
times to warm up and once, behind an L2 flush, stamped.  Prints one JSON
line a case: for the CTA with the most stages, the cycles to its first
copy, and per stage the median cycles of the producer's ``prepare``, its
wait for the slot, its ``fill``, the time from a stage's copies to its
landing and consumer warp 0's groups, then the epilogue's cycles and the
whole walk's; and the clock rate (``clocks.sm`` from nvidia-smi) to read
them in microseconds.  The stamps cost a few registers and shared-memory
stores; the times are the stamped copy's, not the kernel's.
"""
from __future__ import annotations

import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = ("llama", "nemotron", "mixtral", "rgemma")

# (text of ring_decode_step.cuh, what replaces it)
PATCHES = [
    ("#include <cooperative_groups.h>",
     "#include <cooperative_groups.h>\n#include <cstdio>"),
    ("""  const int C = gridDim.x, c = blockIdx.x;

  // the producer's""", """  const int C = gridDim.x, c = blockIdx.x;
  __shared__ long long clk_p[64][3], clk_c[64][2], clk_m[2];
  const bool clk_on = blockIdx.x == 0 && blockIdx.y % 8 == 0;
  const long long clk_t0 = clock64();

  // the producer's"""),
    ("""      ps.prepare(j, lane);
      if (k >= ns) mbar_wait(&empty[s], ((k / ns) - 1) & 1);
      ps.fill(j, ring + s * sb, &full[s], bits + s * kSlotWords, lane);""",
     """      ps.prepare(j, lane);
      if (lane == 0 && k < 64) clk_p[k][0] = clock64() - clk_t0;
      if (k >= ns) mbar_wait(&empty[s], ((k / ns) - 1) & 1);
      if (lane == 0 && k < 64) clk_p[k][1] = clock64() - clk_t0;
      ps.fill(j, ring + s * sb, &full[s], bits + s * kSlotWords, lane);
      if (lane == 0 && k < 64) clk_p[k][2] = clock64() - clk_t0;"""),
    ("""      mbar_wait(&full[s], (k / ns) & 1);
""", """      mbar_wait(&full[s], (k / ns) & 1);
      if (tid == 0 && k < 64) clk_c[k][0] = clock64() - clk_t0;
"""),
    ("""      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);""",
     """      __syncwarp();
      if (tid == 0 && k < 64) clk_c[k][1] = clock64() - clk_t0;
      if (lane == 0) mbar_arrive(&empty[s]);"""),
    ("""    named_sync(1, kConsumers);
    float* wm""", """    if (tid == 0) clk_m[0] = clock64() - clk_t0;
    named_sync(1, kConsumers);
    float* wm"""),
    ("""  if (C == 1) return;
""", """  if (tid == 0) clk_m[1] = clock64() - clk_t0;
  if (C == 1) {
    CLOCK_PRINT
    return;
  }
"""),
    ("""  cluster.sync();  // no CTA leaves while another reads its triple
}""", """  cluster.sync();  // no CTA leaves while another reads its triple
  CLOCK_PRINT
}"""),
]
PRINT = """if (clk_on && tid == 0 && lse == nullptr) {
      const int kk = src.count() < 64 ? src.count() : 64;
      printf("CLK y=%d C=%d stages=%d end=%lld merge=%lld sync=%lld\\n",
             blockIdx.y, C, kk, clock64() - clk_t0, clk_m[0], clk_m[1]);
      for (int k = 0; k < kk; ++k)
        printf("CLK y=%d k=%d %lld %lld %lld %lld %lld\\n", blockIdx.y, k,
               clk_p[k][0], clk_p[k][1], clk_p[k][2], clk_c[k][0],
               clk_c[k][1]);
    }"""


def build_copy():
    """The stamped copy of the kernels, built and loaded in place of the
    library (paged decode's and ring decode's step are stamped alike;
    the cases here run paged decode)."""
    from repro_torch.kernels import cuda_lib
    d = ROOT / "build" / "clock" / "csrc"
    shutil.rmtree(d.parent, ignore_errors=True)
    shutil.copytree(cuda_lib.CSRC, d)
    p = d / "ring_decode_step.cuh"
    s = p.read_text()
    for old, new in PATCHES:
        if s.count(old) != 1:
            raise SystemExit(f"ring_decode_step.cuh has no one {old!r}")
        s = s.replace(old, new.replace("CLOCK_PRINT", PRINT))
    p.write_text(s)
    cuda_lib.CSRC, cuda_lib.BUILD_ROOT = d, d.parent / "build"
    cuda_lib.library.cache_clear()
    cuda_lib.build()


def child(name: str) -> None:
    # the device's printf goes through C's stdout: a line at a time, so
    # that it keeps its place among this process's own lines
    import ctypes
    libc = ctypes.CDLL(None)
    libc.setvbuf(ctypes.c_void_p.in_dll(libc, "stdout"), None, 1, 0)
    sys.path.insert(0, str(ROOT))
    import torch
    import chip_smoke as cs
    cs.setup()
    build_copy()
    from repro_torch.configs import get_config
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    nm, rg = get_config(cs.NEMOTRON), get_config(cs.RGEMMA)
    mx = get_config(cs.MIXTRAL)
    make = {
        "llama": lambda: cs.decode_case(gen, bf),
        "nemotron": lambda: cs.decode_case(
            gen, bf, K=nm.num_kv_heads, G=nm.num_heads // nm.num_kv_heads,
            hd=nm.head_dim_, serve=cs.NEMOTRON_SERVE,
            positions=(cs.NEMOTRON_PROMPT[1],
                       cs.NEMOTRON_PROMPT[1] + cs.NEMOTRON_OUTPUT)),
        "mixtral": lambda: cs.decode_case(
            gen, bf, K=8, G=6, window=mx.sliding_window,
            serve=cs.MIXTRAL_SERVE,
            positions=(cs.MIXTRAL_PROMPT[0],
                       cs.MIXTRAL_PROMPT[1] + cs.MIXTRAL_OUTPUT),
            reclaimed=True),
        "rgemma": lambda: cs.decode_case(
            gen, bf, K=rg.num_kv_heads, G=rg.num_heads // rg.num_kv_heads,
            hd=rg.head_dim_, window=rg.sliding_window, serve=cs.RGEMMA_SERVE,
            positions=(cs.RGEMMA_PROMPT[0],
                       cs.RGEMMA_PROMPT[1] + cs.RGEMMA_OUTPUT),
            reclaimed=True),
    }[name]
    c = make()
    for _ in range(3):
        c["kernel"]()
    torch.cuda.synchronize()
    flush = torch.empty(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    print("CLK stamped", c["shape"], flush=True)
    flush.zero_()
    torch.cuda._sleep(cs.SLEEP_CYCLES)
    c["kernel"]()
    torch.cuda.synchronize()


def summary(name: str, out: str) -> dict:
    """The stamped call's CTA with the most stages, its medians."""
    lines = out[out.index("CLK stamped"):].splitlines()
    shape = lines[0][len("CLK stamped "):]
    heads = {int(m[1]): (int(m[2]), int(m[3]), int(m[4]), int(m[5]))
             for m in (re.match(r"CLK y=(\d+) C=\d+ stages=(\d+) end=(\d+) "
                                r"merge=(\d+) sync=(\d+)", ln)
                       for ln in lines) if m}
    y = max(heads, key=lambda k: heads[k][0])
    stages, end, merge, _ = heads[y]
    rows = sorted((int(m[1]), [int(x) for x in m.groups()[1:]])
                  for m in (re.match(r"CLK y=%d k=(\d+) (-?\d+) (-?\d+) "
                                     r"(-?\d+) (-?\d+) (-?\d+)" % y, ln)
                            for ln in lines) if m)
    st = [r for _, r in rows]
    med = statistics.median
    prev = [0] + [r[2] for r in st[:-1]]     # the last fill's end
    return {
        "case": name, "shape": shape, "cta_y": y, "stages": stages,
        "first_copy_issued_cycles": st[0][2] if st else None,
        "prepare_cycles": med(r[0] - p for r, p in zip(st, prev)),
        "slot_wait_cycles": med(r[1] - r[0] for r in st),
        "fill_cycles": med(r[2] - r[1] for r in st),
        "copy_to_landed_cycles": med(r[3] - r[2] for r in st),
        "consume_cycles": med(r[4] - r[3] for r in st),
        "epilogue_cycles": end - merge,
        "total_cycles": end,
    }


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1])
        return 0
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    device = cs.device_phase()
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{device['kind']}: clocks.sm, clocks.max.sm {clocks.strip()}")
    for name in argv or CASES:
        r = subprocess.run([sys.executable, __file__, "--child", name],
                           capture_output=True, text=True, cwd=ROOT)
        if r.returncode:
            print(r.stdout[-3000:], r.stderr[-3000:])
            return r.returncode
        print(json.dumps(summary(name, r.stdout)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
