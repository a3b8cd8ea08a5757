#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py [--report PATH]

Run it from the root of a checkout.  It builds the port's CUDA kernels
from ``src/repro_torch/csrc`` and drives ``src/repro_torch``; it imports
neither JAX nor the JAX package.  Phases, each fatal on failure:

1. device: ``torch.cuda.get_device_name(0)`` and the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line;
2. build: compile the kernels with nvcc for sm_90a; print ptxas's
   registers and spills of the tensor-core (bf16) prefill kernels, and
   the registers, static and dynamic shared memory and spills of the
   split-KV decode instantiations and of the SGMV kernels;
3. kernels: each of the five hand-written kernels against its plain
   PyTorch version at the shapes the two serving paths give it at the
   widths of Llama-2-7B, in bfloat16 and float32 (and bfloat16 GQA and
   window cases of flash, ring decode, paged decode and paged prefill,
   and SGMV at the row layouts of the two prefills),
   with its median device time, the plain version's, a library yardstick
   where one PyTorch call computes the same function, the least time the
   card could take for the work (``bound_ms``) and the share of it the
   kernel reaches (``bound_share`` = bound_ms / ms); then each attention
   wrapper must refuse a ``q``, and SGMV an ``x``, one element off a
   16-byte boundary;
4. serve: ``ContinuousRuntime`` + ``replay_trace`` at the full width of
   Llama-2-7B (random weights from a seed, a 4-adapter LoRA bank, a
   shared-prefix multi-adapter trace).  Every request must finish, the
   books must balance, no logit or pool entry may be non-finite, and every
   kernel's launch count must equal layers x dispatches x sites.  A
   breakdown follows: one prefill admission and four decode chunks timed
   on the host clock, then the same round again, from the same state on
   fresh prompts of the same lengths, under ``torch.profiler`` for the
   device's busy time by kind (hence its idle share);
5. warm functions: the launcher ``repro_torch.launch.serve`` on the same
   weights (``BackboneStore`` + one ``FunctionInstance`` per adapter, the
   adaptive ``BatchingScheduler``, ``InferenceEngine.generate`` over ring
   caches): 32 requests of 500 prompt tokens and 32 new tokens.  Every
   request must be served, no logit may be non-finite, the four handles
   must read the very backbone tensors, and the launch counts must equal
   layers x (prefill calls | decode steps) x sites.  Then one batch's
   prefill and decode steps are timed on the host clock and, from the same
   state, under ``torch.profiler`` (device busy, hence idle share);
6. parity: the SMOKE config in float32, replayed through the serving
   runtime on the card (kernels) and on the CPU (plain versions), must emit
   the same tokens, greedy and sampled; and ``InferenceEngine.generate``
   on the two devices must emit the same greedy tokens.

``--report`` writes every number to a JSON file.  The model of phases 4
and 5 runs at its full depth.  The last two lines of output are a
``{"kernels": [...]}`` object and ``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside a checkout, the script exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA data sheet (dense rates, 700 W): HBM3 bytes/s, and the
# peak rate for each operand type — bf16 on the tensor cores, float32 on
# the CUDA cores (no TF32).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version: max |diff| <= TOL * max(1, max |plain|).  Both
# sides compute in float32; float32 differs only in summation order, and
# bfloat16 outputs may round one unit (2^-8 relative) apart: 2^-7 allows two.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SLEEP_CYCLES = 2_000_000     # ~1 ms of device sleep ahead of a timed launch
FLUSH_BYTES = 256 << 20      # > the 50 MB L2: every timed launch starts cold

# Phase 4: Llama-2-7B serving shapes
SERVE = dict(num_slots=8, block_size=16, num_blocks=1024,
             max_blocks_per_slot=64, prefill_chunk=64, prefill_rows=4,
             decode_chunk=4)
ADAPTERS = 4
REQUESTS = 12
SYSTEM_PROMPT = 128          # per-adapter shared prefix (8 whole blocks)
MAX_PROMPT = 768
OUTPUT_TOKENS = 32

# Phase 5: the warm-function launcher's flags.  Its scheduler forms
# batches of 1-3 rows at these flags; phase 3 times the ring-engine kernels
# at the largest, LAUNCH_BATCH rows.
LAUNCH = dict(adapters=4, requests=32, prompt_len=500, max_new=32, rate=50.0)
LAUNCH_BATCH = 3
LAUNCH_CONTEXT = LAUNCH["prompt_len"] + LAUNCH["max_new"] + 8   # ring S

KERNEL_SOURCES = {
    "sgmv": ("src/repro_torch/csrc/sgmv.cu",
             "src/repro/kernels/sgmv/sgmv.py:28"),
    "paged_attention": ("src/repro_torch/csrc/paged_attn.cu",
                        "src/repro/kernels/paged_attention/paged_attn.py:48"),
    "paged_prefill": ("src/repro_torch/csrc/paged_prefill.cu",
                      "src/repro/kernels/paged_prefill/prefill_attn.py:52"),
    "flash_attention": ("src/repro_torch/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attention/flash.py:33"),
    "decode_attention": ("src/repro_torch/csrc/decode_attn.cu",
                         "src/repro/kernels/decode_attention/"
                         "decode_attn.py:34"),
}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def phase(title: str):
    print(f"== {title}", flush=True)
    return time.perf_counter()


# --------------------------------------------------------------- 1. device
def device_phase() -> Dict:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA "
             "card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             f"(no src/repro_torch/csrc)")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = phase("phase 1: device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False)
    lines = [ln.strip() for ln in smi.stdout.splitlines() if ln.strip()]
    if smi.returncode or not lines:
        fail(f"nvidia-smi failed ({smi.returncode}): {smi.stderr.strip()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} card(s) visible; device 0: {name}")
    for ln in lines:
        print(ln)
    print(f"phase 1 ok ({time.perf_counter() - t0:.1f} s)")
    return {"kind": name, "count": torch.cuda.device_count(),
            "nvidia_smi": lines}


# ---------------------------------------------------------------- 2. build
def ptxas_usage(log: str) -> List[Dict]:
    """Registers, static shared memory and spills of each kernel
    instantiation, from the ``-Xptxas -v`` lines of the build log."""
    out: List[Dict] = []
    cur: Dict = {}
    for ln in log.splitlines():
        if "Function properties for" in ln:
            cur = {"function": ln.split("Function properties for")[1].strip()}
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", ln):
            cur.update(spill_stores=int(m[1]), spill_loads=int(m[2]))
            if frame := re.search(r"(\d+) bytes stack frame", ln):
                cur["stack_frame"] = int(frame[1])
        elif (m := re.search(r"Used (\d+) registers", ln)) and cur:
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append({**cur, "registers": int(m[1]),
                        "static_smem": int(smem[1]) if smem else 0})
            cur = {}
    return out


def decode_instance(function: str) -> Optional[Dict]:
    """(kernel, dtype, hd, GP) of a split-KV decode instantiation's mangled
    name, or None for any other kernel."""
    m = re.search(r"(ring|paged)_decode_part_kernelI(13__nv_bfloat16|f)"
                  r"Li(\d+)ELi(\d+)E", function)
    if m is None:
        return None
    return {"kernel": f"{m[1]}_decode", "dtype": "bfloat16" if m[2] != "f"
            else "float32", "hd": int(m[3]), "G": int(m[4])}


def build_phase() -> Dict:
    from repro_torch.kernels import cuda_lib
    t0 = phase("phase 2: build")
    info = cuda_lib.build()
    cuda_lib.library()
    usage = ptxas_usage(info.log)
    print(f"built {info.path} in {info.seconds:.1f} s "
          f"({'fresh' if info.built else 'cached'}); ptxas: "
          f"{len(usage)} kernel instantiations, "
          f"{sum(u.get('spill_stores', 0) for u in usage)} bytes of spill "
          f"stores in all")
    # the tensor-core prefill steps (bf16): registers and spills
    for u in usage:
        if "_bf16" in u["function"]:
            print(f"ptxas {u['function']}: {u['registers']} registers, "
                  f"spill stores {u.get('spill_stores')} B, spill loads "
                  f"{u.get('spill_loads')} B")
    # the split-KV decode steps: also their shared memory, the dynamic
    # part at the wrappers' partition and G query heads per kv head
    from repro_torch.kernels.decode_attention.ops import PARTITION
    lib = cuda_lib.library()
    for u in usage:
        d = decode_instance(u["function"])
        if d is None:
            continue
        u["decode"] = d
        u["dynamic_smem"] = lib.decode_smem_bytes(
            d["hd"], cuda_lib.DTYPE_CODES[getattr(torch, d["dtype"])],
            PARTITION, d["G"])
        print(f"ptxas {d['kernel']} {d['dtype']} hd {d['hd']} G<={d['G']}: "
              f"{u['registers']} registers, static smem "
              f"{u['static_smem']} B, dynamic smem {u['dynamic_smem']} B "
              f"at {PARTITION} slots x G {d['G']}, spill stores "
              f"{u.get('spill_stores')} B, spill loads "
              f"{u.get('spill_loads')} B")
    # SGMV: the bf16 row-tile kernels and the float32 CUDA-core ones (all
    # static shared memory)
    for u in usage:
        if "sgmv_" in u["function"]:
            print(f"ptxas {u['function']}: {u['registers']} registers, "
                  f"static smem {u['static_smem']} B, stack frame "
                  f"{u.get('stack_frame')} B, spill stores "
                  f"{u.get('spill_stores')} B, spill loads "
                  f"{u.get('spill_loads')} B")
    print(f"phase 2 ok ({time.perf_counter() - t0:.1f} s)")
    return {"seconds": info.seconds, "fresh": info.built, "ptxas": usage}


# -------------------------------------------------------------- 3. kernels
def device_ms(fn: Callable[[], object], iters: int,
              flush: torch.Tensor, read_flush: bool = False) -> float:
    """Median device time (ms) of one ``fn()``.  Each timed call runs with
    the L2 cache flushed and behind a device sleep long enough for the host
    to enqueue it, so the two events bracket device work only.  The flush
    writes ``flush``, which leaves the L2 full of dirty lines, or with
    ``read_flush`` reads it, which leaves clean ones."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(iters):
        if read_flush:
            flush.sum()
        else:
            flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bound(nbytes: float, ops: float, dtype: torch.dtype) -> Dict:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return {"bytes": int(nbytes), "ops": int(ops),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _randn(gen, *shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale
            ).to(dtype)


def paged_table(gen, B: int, MB: int, NB: int,
                last_block: torch.Tensor) -> torch.Tensor:
    """(B, MB) int32 table of distinct physical blocks (never the garbage
    block 0), -1 past each row's ``last_block``."""
    perm = torch.randperm(NB - 1, generator=gen, device="cuda")[:B * MB] + 1
    tbl = perm.view(B, MB).to(torch.int32)
    j = torch.arange(MB, device="cuda")
    return torch.where(j[None] <= last_block[:, None], tbl,
                       torch.full_like(tbl, -1)).contiguous()


def sgmv_case(gen, dtype, R: int, run: int = 1,
              adapters: int = ADAPTERS) -> Dict:
    """Rows in runs of ``run`` consecutive rows, run i carrying adapter
    i % ``adapters`` of a bank of ADAPTERS (run 1: interleaved, the worst
    case for the kernel's per-tile passes; the prefills send token-major
    runs of a request's length), the last row out of range."""
    from repro_torch.kernels.sgmv.ops import sgmv_apply
    from repro_torch.kernels.sgmv.ref import sgmv_ref
    D = O = 4096
    r, N = 16, ADAPTERS
    x = _randn(gen, R, D, dtype=dtype)
    a = _randn(gen, N, D, r, dtype=dtype, scale=1 / math.sqrt(D))
    b = _randn(gen, N, r, O, dtype=dtype, scale=0.02)
    idx = (torch.arange(R, device="cuda") // run % adapters).to(torch.int32)
    idx[-1] = N                            # out of range: an exact zero row
    es = x.element_size()
    valid = int((idx < N).sum())
    used = len(set(idx.tolist()) - {N})
    library, label = None, "none"
    if adapters == 1:
        # one adapter: a chain of two products times the same work, but
        # rounds xa to bf16 (a yardstick of time; its values are not
        # compared)
        library = lambda: torch.linalg.multi_dot(        # noqa: E731
            (x, a[0], b[0]))
        label = ("torch.linalg.multi_dot((x, a[0], b[0])): time yardstick "
                 "only, rounds xa to the storage dtype")
    return dict(
        shape=f"R={R} D={D} r={r} O={O} N={N} run={run} adapters={used}",
        kernel=lambda: sgmv_apply(x, a, b, idx, scaling=2.0),
        plain=lambda: sgmv_ref(x, a, b, idx, scaling=2.0),
        library=library, library_label=label,
        zero_rows=[R - 1],
        **bound(es * (R * D + used * r * (D + O) + R * O) + 4 * R,
                2 * valid * r * (D + O), dtype))


def decode_case(gen, dtype, K: int = 32, G: int = 1,
                window: Optional[int] = None) -> Dict:
    """Runtime decode: one token for each of ``num_slots`` rows over its
    paged history, at Llama-2-7B head widths (``H = K * G`` query
    heads)."""
    from repro_torch.kernels.paged_attention.ops import paged_decode_gqa
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B, hd = SERVE["num_slots"], 128
    NB, bs, MB = SERVE["num_blocks"], SERVE["block_size"], \
        SERVE["max_blocks_per_slot"]
    H = K * G
    kp = _randn(gen, K, NB, bs, hd, dtype=dtype)
    vp = _randn(gen, K, NB, bs, hd, dtype=dtype)
    q = _randn(gen, B, H, hd, dtype=dtype)
    pos = torch.randint(SYSTEM_PROMPT, MAX_PROMPT + OUTPUT_TOKENS, (B,),
                        generator=gen, device="cuda", dtype=torch.int32)
    pos[-1] = 0                            # an inactive slot ...
    tbl = paged_table(gen, B, MB, NB, pos // bs)
    tbl[-1] = -1                           # ... whose table is all -1
    tbl[1, 2] = -1                         # a hole inside a live row
    t = torch.arange(MB * bs, device="cuda")
    ok = (t[None] <= pos[:, None]) & (tbl[:, t // bs] >= 0)
    if window is not None:
        ok = ok & (t[None] > pos[:, None] - window)
    live = int(ok.sum())
    es = q.element_size()
    # library yardstick: SDPA over K/V already gathered contiguous
    L = int(pos.max()) + 1
    nblk = -(-L // bs)
    phys = tbl[:, :nblk].clamp(min=0).long()
    kc = kp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, nblk * bs, hd)
    vc = vp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, nblk * bs, hd)
    kc = kc[:, :, :L].repeat_interleave(G, dim=1).contiguous()
    vc = vc[:, :, :L].repeat_interleave(G, dim=1).contiguous()
    mask = ok[:, None, None, :L].contiguous()
    q4 = q[:, :, None, :].contiguous()
    return dict(
        shape=f"B={B} K={K} G={G} hd={hd} NB={NB} bs={bs} MB={MB} "
              f"window={window} live_keys={live}",
        kernel=lambda: paged_decode_gqa(q, kp, vp, tbl, pos, window=window),
        plain=lambda: paged_attention_ref(q, kp, vp, tbl, pos,
                                          window=window),
        library=lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                       attn_mask=mask),
        library_label="scaled_dot_product_attention over K/V already "
                      "gathered contiguous"
                      + (", repeated per head" if G > 1 else ""),
        zero_rows=[B - 1],
        **bound(es * (2 * live * K * hd + 2 * B * H * hd)
                + 4 * (B * MB + B), 4 * hd * H * live, dtype))


def prefill_case(gen, dtype, K: int = 32, G: int = 1,
                 window: Optional[int] = None) -> Dict:
    """Runtime prefill: a chunk of ``prefill_chunk`` queries for each of
    ``prefill_rows`` rows over its paged history, at Llama-2-7B head
    widths (``H = K * G`` query heads)."""
    from repro_torch.kernels.paged_prefill.ops import paged_prefill_gqa
    from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref
    B, C = SERVE["prefill_rows"], SERVE["prefill_chunk"]
    hd = 128
    NB, bs, MB = SERVE["num_blocks"], SERVE["block_size"], \
        SERVE["max_blocks_per_slot"]
    H = K * G
    kp = _randn(gen, K, NB, bs, hd, dtype=dtype)
    vp = _randn(gen, K, NB, bs, hd, dtype=dtype)
    q = _randn(gen, B, C, H, hd, dtype=dtype)
    start = bs * torch.randint(0, (MAX_PROMPT - C) // bs + 1, (B,),
                               generator=gen, device="cuda",
                               dtype=torch.int32)
    q_pos = (start[:, None] + torch.arange(C, device="cuda")[None]
             ).to(torch.int32).contiguous()
    tbl = paged_table(gen, B, MB, NB, (start + C - 1) // bs)
    t = torch.arange(MB * bs, device="cuda")
    valid = tbl[:, t // bs] >= 0                              # (B, S)
    ok = (t[None, None] <= q_pos[:, :, None]) & valid[:, None]  # (B, C, S)
    seen = valid & (t[None] <= (start + C - 1)[:, None])
    if window is not None:
        ok = ok & (t[None, None] > q_pos[:, :, None] - window)
        seen = seen & (t[None] > (start - window)[:, None])
    keys = int(seen.sum())
    es = q.element_size()
    L = int(start.max()) + C
    nblk = -(-L // bs)
    phys = tbl[:, :nblk].clamp(min=0).long()
    kc = kp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, nblk * bs, hd)
    vc = vp[:, phys].permute(1, 0, 2, 3, 4).reshape(B, K, nblk * bs, hd)
    kc = kc[:, :, :L].repeat_interleave(G, dim=1).contiguous()
    vc = vc[:, :, :L].repeat_interleave(G, dim=1).contiguous()
    mask = ok[:, None, :, :L].contiguous()
    q4 = q.permute(0, 2, 1, 3).contiguous()
    return dict(
        shape=f"B={B} C={C} K={K} G={G} hd={hd} NB={NB} bs={bs} MB={MB} "
              f"window={window} history_keys={keys}",
        kernel=lambda: paged_prefill_gqa(q, kp, vp, tbl, q_pos,
                                         window=window),
        plain=lambda: paged_prefill_ref(q, kp, vp, tbl, q_pos,
                                        window=window),
        library=lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                       attn_mask=mask),
        library_label="scaled_dot_product_attention over K/V already "
                      "gathered contiguous"
                      + (", repeated per head" if G > 1 else ""),
        zero_rows=[],
        **bound(es * (2 * keys * K * hd + 2 * B * C * H * hd)
                + 4 * (B * MB + B * C), 4 * hd * H * int(ok.sum()), dtype))


def flash_case(gen, dtype, B: int, T: int, K: int, G: int,
               window: Optional[int] = None) -> Dict:
    """Ring-engine prefill: causal attention of B rows of T tokens over
    their own keys, at Llama-2-7B head widths."""
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.flash_attention.ref import flash_ref
    hd, H = 128, K * G
    q = _randn(gen, B, T, H, hd, dtype=dtype)
    k = _randn(gen, B, T, K, hd, dtype=dtype)
    v = _randn(gen, B, T, K, hd, dtype=dtype)
    i = torch.arange(T, device="cuda")
    ok = i[None, :] <= i[:, None]
    if window is not None:
        ok = ok & (i[None, :] > i[:, None] - window)
    pairs = int(ok.sum())
    es = q.element_size()
    # library yardstick: SDPA over (B, H, T, hd) copies, K/V repeated to H
    # heads for GQA (the copies are not timed)
    q4 = q.transpose(1, 2).contiguous()
    k4 = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    v4 = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    if window is None:
        library = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4, is_causal=True)
    else:
        library = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4, attn_mask=ok)
    return dict(
        shape=f"B={B} T={T} H={H} K={K} hd={hd} causal window={window}",
        kernel=lambda: flash_mha(q, k, v, causal=True, window=window),
        plain=lambda: flash_ref(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=window).transpose(1, 2),
        library=library,
        library_label="scaled_dot_product_attention over (B, H, T, hd) "
                      "copies" + (", K/V repeated per head" if G > 1
                                  else ""),
        zero_rows=[],
        **bound(es * (2 * B * T * H * hd + 2 * B * T * K * hd),
                4 * hd * H * B * pairs, dtype))


def ring_decode_case(gen, dtype, B: int, S: int, K: int, G: int, pos: int,
                     window: Optional[int] = None) -> Dict:
    """Ring-engine decode: one token per row over a ring of S slots that
    has seen positions 0..pos (slot = position % S; wrapped when pos >=
    S)."""
    from repro_torch.kernels.decode_attention.ops import decode_gqa
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref
    hd, H = 128, K * G
    q = _randn(gen, B, H, hd, dtype=dtype)
    k = _randn(gen, B, S, K, hd, dtype=dtype)
    v = _randn(gen, B, S, K, hd, dtype=dtype)
    p = torch.arange(max(0, pos - S + 1), pos + 1, device="cuda",
                     dtype=torch.int32)
    slot_pos = torch.full((S,), -1, dtype=torch.int32, device="cuda")
    slot_pos[(p % S).long()] = p
    ok = (slot_pos >= 0) & (slot_pos <= pos)
    if window is not None:
        ok = ok & (slot_pos > pos - window)
    valid = int(ok.sum())
    es = q.element_size()
    # library yardstick: SDPA over K/V already in (B, H, S, hd) and a
    # boolean slot mask (the transposes are not timed)
    q4 = q[:, :, None, :].contiguous()
    k4 = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    v4 = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    mask = ok[None, None, None, :].contiguous()
    return dict(
        shape=f"B={B} S={S} K={K} G={G} hd={hd} pos={pos} window={window} "
              f"valid_slots={valid}",
        kernel=lambda: decode_gqa(q, k, v, slot_pos, pos, window=window),
        plain=lambda: decode_attention_ref(q, k, v, slot_pos, pos,
                                           window=window),
        library=lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       attn_mask=mask),
        library_label="scaled_dot_product_attention over K/V already "
                      "transposed to (B, H, S, hd)",
        zero_rows=[],
        **bound(es * (2 * B * valid * K * hd + 2 * B * H * hd) + 4 * S,
                4 * hd * H * B * valid, dtype))


def kernels_phase() -> Dict[str, Dict]:
    """Every kernel against its plain version; the bf16 cases are timed.
    Returns name -> the numbers of its first timed (main-path) case."""
    t0 = phase("phase 3: kernels vs plain versions on the card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    Bl, T, S = LAUNCH_BATCH, LAUNCH["prompt_len"], LAUNCH_CONTEXT
    last = T + LAUNCH["max_new"] - 2        # position of the last decode
    makers = []
    for dtype in (torch.bfloat16, torch.float32):
        makers += [
            ("sgmv", dtype,
             lambda d=dtype: sgmv_case(gen, d, SERVE["num_slots"])),
            ("sgmv", dtype, lambda d=dtype: sgmv_case(
                gen, d, SERVE["prefill_rows"] * SERVE["prefill_chunk"])),
            ("paged_attention", dtype, lambda d=dtype: decode_case(gen, d)),
            ("paged_prefill", dtype, lambda d=dtype: prefill_case(gen, d)),
            # ring engine: the launcher's shapes first, then a batch of 8,
            # GQA (32 query heads over 8 kv heads) and a window
            ("flash_attention", dtype,
             lambda d=dtype: flash_case(gen, d, Bl, T, 32, 1)),
            ("decode_attention", dtype,
             lambda d=dtype: ring_decode_case(gen, d, Bl, S, 32, 1, last))]
    bf = torch.bfloat16
    makers += [
        ("flash_attention", bf, lambda: flash_case(gen, bf, 8, T, 32, 1)),
        ("flash_attention", bf, lambda: flash_case(gen, bf, Bl, T, 8, 4)),
        ("flash_attention", bf,
         lambda: flash_case(gen, bf, Bl, T, 32, 1, window=128)),
        ("decode_attention", bf,
         lambda: ring_decode_case(gen, bf, 8, S, 32, 1, 2 * S + 17)),
        ("decode_attention", bf,
         lambda: ring_decode_case(gen, bf, Bl, S, 8, 4, last)),
        ("decode_attention", bf,
         lambda: ring_decode_case(gen, bf, Bl, S, 32, 1, 2 * S + 17,
                                  window=128)),
        ("paged_prefill", bf, lambda: prefill_case(gen, bf, K=8, G=4)),
        ("paged_prefill", bf, lambda: prefill_case(gen, bf, window=128)),
        ("paged_attention", bf, lambda: decode_case(gen, bf, K=8, G=4)),
        ("paged_attention", bf, lambda: decode_case(gen, bf, window=128)),
        # SGMV at the prefills' row layouts: the runtime's 4 rows x 64
        # tokens of 4 adapters, the launcher's 3 x 500 of one adapter
        ("sgmv", bf, lambda: sgmv_case(
            gen, bf, SERVE["prefill_rows"] * SERVE["prefill_chunk"],
            run=SERVE["prefill_chunk"])),
        ("sgmv", bf, lambda: sgmv_case(
            gen, bf, LAUNCH_BATCH * LAUNCH["prompt_len"],
            run=LAUNCH["prompt_len"], adapters=1))]
    summary: Dict[str, Dict] = {}
    results: List[Dict] = []
    for name, dtype, make in makers:
        c = make()
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {c['shape']}: kernel gives {tuple(got.shape)} "
                 f"{got.dtype}, plain {tuple(want.shape)} {want.dtype}")
        if not torch.isfinite(got).all():
            fail(f"{name} {c['shape']} {dtype}: non-finite kernel output")
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        tol = TOL[dtype] * scale
        for row in c["zero_rows"]:
            if bool(got[row].any()):
                fail(f"{name}: row {row} must be exact zeros")
        row = {"name": name, "dtype": str(dtype).replace("torch.", ""),
               "shape": c["shape"], "max_abs_err": err, "tol": tol,
               "bytes": c["bytes"], "ops": c["ops"],
               "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
               "library": c["library_label"]}
        if dtype == torch.bfloat16:
            row["ms"] = device_ms(c["kernel"], 50, flush)
            row["plain_ms"] = device_ms(c["plain"], 10, flush)
            row["library_ms"] = (device_ms(c["library"], 50, flush)
                                 if c["library"] is not None else None)
            row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row))
        if not err <= tol:
            fail(f"{name} {c['shape']} {dtype}: max |kernel - plain| = "
                 f"{err:.3e} > {tol:.3e}")
        results.append(row)
        summary.setdefault(name, row)
        del c, got, want
    torch.cuda.empty_cache()
    refused = alignment_cases(gen)
    print(f"phase 3 ok: {len(results)} cases within tolerance, "
          f"{refused} wrappers refuse a misaligned operand "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"summary": summary, "cases": results}


def alignment_cases(gen) -> int:
    """Each attention wrapper stages q, K and V with 16-byte copies and
    must refuse (ValueError) a ``q`` one element off a 16-byte boundary
    rather than launch: its kernel has no unaligned path.  So must SGMV in
    bf16 an ``x``."""
    from repro_torch.kernels.decode_attention.ops import decode_gqa
    from repro_torch.kernels.flash_attention.ops import flash_mha
    from repro_torch.kernels.paged_attention.ops import paged_decode_gqa
    from repro_torch.kernels.paged_prefill.ops import paged_prefill_gqa
    from repro_torch.kernels.sgmv.ops import sgmv_apply
    bf, B, K, hd, S, bs = torch.bfloat16, 2, 4, 128, 64, 16

    def off_by_one(shape):
        buf = _randn(gen, math.prod(shape) + 1, dtype=bf)
        return buf[1:].view(shape)

    cache = _randn(gen, B, S, K, hd, dtype=bf)
    pool = _randn(gen, K, 8, bs, hd, dtype=bf)
    tbl = torch.arange(1, 5, device="cuda", dtype=torch.int32).repeat(B, 1)
    pos = torch.full((B,), S - 1, device="cuda", dtype=torch.int32)
    slot_pos = torch.arange(S, device="cuda", dtype=torch.int32)
    q_pos = torch.arange(bs, device="cuda", dtype=torch.int32).repeat(B, 1)
    calls = {
        "decode_attention": lambda: decode_gqa(
            off_by_one((B, K, hd)), cache, cache, slot_pos, S - 1),
        "paged_attention": lambda: paged_decode_gqa(
            off_by_one((B, K, hd)), pool, pool, tbl, pos),
        "flash_attention": lambda: flash_mha(
            off_by_one((B, S, K, hd)), cache, cache, causal=True),
        "paged_prefill": lambda: paged_prefill_gqa(
            off_by_one((B, bs, K, hd)), pool, pool, tbl, q_pos),
        "sgmv": lambda: sgmv_apply(
            off_by_one((B, K * hd)), _randn(gen, 2, K * hd, 16, dtype=bf),
            _randn(gen, 2, 16, K * hd, dtype=bf),
            torch.zeros(B, device="cuda", dtype=torch.int32)),
    }
    for name, call in calls.items():
        try:
            call()
        except ValueError as e:
            print(f"{name}: {'x' if name == 'sgmv' else 'q'} one element "
                  f"off a 16-byte boundary refused: {e}")
        else:
            fail(f"{name}: an operand one element off a 16-byte boundary "
                 f"was launched")
    return len(calls)


# ---------------------------------------------------------------- 4. serve
def shared_prefix_trace(n_req: int, n_fn: int, system: int, max_prompt: int,
                        out_tokens: int, vocab: int, seed: int):
    """Per-adapter system prompts of ``system`` tokens + private suffixes
    (prompts ``system``..``max_prompt`` tokens), adapters round robin."""
    rng = np.random.default_rng(seed)
    sys_prompt = {f: rng.integers(0, vocab, system).astype(np.int32)
                  for f in range(n_fn)}
    work, prompts = [], {}
    for rid in range(n_req):
        f = rid % n_fn
        suffix = rng.integers(0, vocab, int(rng.integers(
            0, max_prompt - system + 1))).astype(np.int32)
        prompts[rid] = np.concatenate([sys_prompt[f], suffix])
        work.append(dict(req_id=rid, fn_id=f"fn{f}", arrival=0.02 * rid,
                         prompt_len=len(prompts[rid]),
                         output_len=out_tokens, slo_ttft=1e9))
    return work, prompts, {f"fn{f}": f for f in range(n_fn)}


def model_params():
    """Llama-2-7B at full width with a 4-adapter rank-16 LoRA bank on
    q/k/v/o, random from seed 0, for phases 4 and 5."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import LoRAConfig
    cfg = get_config("llama2_7b").with_(
        lora=LoRAConfig(rank=16, alpha=32.0, num_adapters=ADAPTERS))
    print(f"model: {cfg.name}, {cfg.num_layers} layers (no depth cut), "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads x "
          f"{cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.dtype}; LoRA rank {cfg.lora.rank} on "
          f"{'/'.join(cfg.lora.targets)}, bank of {ADAPTERS}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t_init = time.perf_counter()
    params = tf.init_params(cfg, gen, "cuda", lora_adapters=ADAPTERS)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"weights: {n_bytes / 1e9:.2f} GB random from seed 0 in "
          f"{time.perf_counter() - t_init:.1f} s")
    return cfg, params


class FiniteLogits:
    """Within the block, every LM-head output is checked for non-finite
    values (the flags stay on the device until ``ok`` is read)."""

    def __enter__(self):
        from repro_torch.models import transformer as tf
        self.tf, self.plain, self.flags = tf, tf._logits, []

        def checked(p, c, x):
            out = self.plain(p, c, x)
            self.flags.append(torch.isfinite(out).all())
            return out

        tf._logits = checked
        return self

    def __exit__(self, *exc):
        self.tf._logits = self.plain

    def ok(self) -> bool:
        return bool(self.flags) and bool(torch.stack(self.flags).all())


def serve_phase(cfg, params) -> Dict:
    from repro_torch import kernels
    from repro_torch.serving import (ContinuousRuntime, ServingConfig,
                                     replay_trace, terminal_state)

    t0 = phase("phase 4: serve Llama-2-7B on the card")
    layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    scfg = ServingConfig(**SERVE)
    rt = ContinuousRuntime(cfg, params, scfg)
    print(f"serving: {SERVE}")
    work, prompts, fn_adapter = shared_prefix_trace(
        REQUESTS, ADAPTERS, SYSTEM_PROMPT, MAX_PROMPT, OUTPUT_TOKENS,
        cfg.vocab_size, seed=0)
    print(f"trace: {len(work)} greedy requests, {ADAPTERS} adapters, "
          f"prompts {min(w['prompt_len'] for w in work)}-"
          f"{max(w['prompt_len'] for w in work)} tokens "
          f"({SYSTEM_PROMPT}-token system prompt per adapter), "
          f"{OUTPUT_TOKENS} output tokens")

    sink: Dict[int, List[int]] = {}
    with FiniteLogits() as finite:
        kernels.reset_launches()
        t_run = time.perf_counter()
        res, _ = replay_trace(rt, work, fn_adapter, prompts=prompts,
                              prefill_group=SERVE["prefill_rows"],
                              token_sink=sink)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_run
    launches = kernels.launch_counts()

    for r in res.requests:
        print(f"req {r.req_id:2d} fn{fn_adapter[r.fn_id]} prompt "
              f"{r.prompt_len:3d}: {terminal_state(r)}, "
              f"{len(sink.get(r.req_id, []))} tokens, ttft "
              f"{r.first_token - r.arrival:.4f} s, done at {r.done:.4f} s")
    states = [terminal_state(r) for r in res.requests]
    if states != ["finished"] * len(work):
        fail(f"not every request finished: {states}")
    if any(len(sink[w["req_id"]]) != OUTPUT_TOKENS for w in work):
        fail("a request emitted the wrong number of tokens")
    report = rt.check_invariants(res.requests)
    if report["pool"]["live"] != 0 or report["slots_active"] != 0:
        fail(f"blocks or slots still held after the drain: {report}")
    if not finite.ok():
        fail("non-finite logits during the replay")
    for layer in rt.cache:
        for pool in layer.values():
            if not bool(torch.isfinite(pool).all()):
                fail("non-finite entries in a KV pool")

    prefills = rt.stats["prefill_chunks"] + 2          # + warmup's two
    steps = (rt.stats["decode_chunks"] + 2) * scfg.decode_chunk
    sites = len(cfg.lora.targets)
    expected = {"sgmv": sites * layers * (prefills + steps),
                "paged_attention": layers * steps,
                "paged_prefill": layers * prefills,
                "flash_attention": 0, "decode_attention": 0}
    print(f"launches {launches}, expected {expected} ({prefills} prefill "
          f"dispatches, {steps} decode steps incl. warmup, {layers} "
          f"layers, {sites} LoRA sites)")
    if launches != expected:
        fail("launch counts differ from layers x dispatches x sites")

    m = rt.metrics.histogram
    ttft, tpot = m("ttft_s").summary(), m("tpot_s").summary()
    tokens = sum(len(v) for v in sink.values())
    span = max(r.done for r in res.requests) - min(
        r.arrival for r in res.requests)
    out = {
        "layers": layers, "requests": len(work), "tokens": tokens,
        "ttft_p50_s": ttft["p50"], "ttft_p95_s": ttft["p95"],
        "tpot_p50_s": tpot["p50"], "tpot_p95_s": tpot["p95"],
        "tokens_per_s": tokens / span, "replay_wall_s": wall,
        "prefill_dispatches": prefills, "decode_steps": steps,
        "shared_block_maps": rt.stats["shared_block_maps"],
        "recomputed_tokens": rt.stats["recomputed_tokens"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches,
        "launches_per_prefill_dispatch": {
            "sgmv": sites * layers, "paged_prefill": layers},
        "launches_per_decode_step": {
            "sgmv": sites * layers, "paged_attention": layers},
    }
    print(f"TTFT p50 {out['ttft_p50_s']:.4f} s, TPOT p50 "
          f"{out['tpot_p50_s']:.4f} s, {out['tokens_per_s']:.1f} tokens/s "
          f"(replay clock), replay wall {wall:.1f} s, peak memory "
          f"{out['peak_memory_gb']:.2f} GB, shared block maps "
          f"{out['shared_block_maps']}")
    out["breakdown"] = breakdown(rt, cfg)
    del rt
    torch.cuda.empty_cache()
    print(f"phase 4 ok ({time.perf_counter() - t0:.1f} s)")
    return out


def _kernel_kind(name: str) -> str:
    low = name.lower()
    for key, kind in (("sgmv_shrink", "sgmv_shrink"),
                      ("sgmv_expand", "sgmv_expand"),
                      ("paged_decode", "paged_attention"),
                      ("paged_prefill", "paged_prefill"),
                      ("flash_kernel", "flash_attention"),
                      ("ring_decode", "decode_attention"),
                      ("split_kv_merge", "decode_merge"),
                      ("memcpy", "copy"), ("memset", "copy")):
        if key in low:
            return kind
    if any(k in low for k in ("gemm", "gemv", "nvjet", "cutlass", "xmma")):
        return "matmul"
    return "other"


def _union_ms(spans: List) -> float:
    """Length (ms) of the union of (start, end) intervals in µs."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return (busy + cur_e - cur_s) / 1e3 if spans else 0.0


def profiled(fn: Callable[[], object]) -> Dict:
    """Run ``fn`` once under ``torch.profiler``: the union of device
    activity and device time by kind (the profiler's host wall time is
    kept too; it is inflated by the tracing itself).  SGMV's expand is
    resident while its shrink runs, so the two kinds overlap:
    ``sgmv_union_ms`` counts their time once."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    spans, sgmv, by_kind = [], [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        kind = _kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (end - start) / 1e3
        if kind.startswith("sgmv"):
            sgmv.append((start, end))
    if not spans:
        return {"profiled_wall_ms": host_ms, "device_busy_ms": None,
                "device_ms_by_kind": None,
                "note": "the profiler saw no device events: not measured"}
    return {"profiled_wall_ms": host_ms, "device_busy_ms": _union_ms(spans),
            "device_ms_by_kind": dict(sorted(by_kind.items())),
            "sgmv_union_ms": _union_ms(sgmv)}


def wall_ms(fn: Callable[[], object]) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def breakdown(rt, cfg) -> Dict:
    """Where the time of the two dispatches goes, at full width.  A round
    admits two groups of ``prefill_rows`` fresh 512-token prompts (8 prefill
    dispatches each), which fills the slots, runs 4 decode chunks with
    every slot busy, and drains the pool.  Two rounds run from the same
    empty state on fresh prompts of the same lengths, so both see the same
    shapes: the first is timed on the host clock alone, the second under
    the profiler for device time by kind.  The idle share is 1 - device
    busy / unprofiled host wall; a busy time above that wall fails."""
    from repro_torch.serving import ServeRequest
    rng = np.random.default_rng(1)
    scfg = rt.scfg
    g = scfg.prefill_rows
    if 2 * g > scfg.num_slots:
        fail("breakdown needs two admission groups of free slots")

    def fresh() -> List:
        # 32 new tokens outlive the 16 measured decode steps
        return [ServeRequest(prompt=rng.integers(0, cfg.vocab_size, 512),
                             adapter=i % ADAPTERS, max_new_tokens=32)
                for i in range(2 * g)]

    def admit(reqs) -> None:
        for group in (reqs[:g], reqs[g:]):
            a = rt.try_admit(group)
            if a is None or a.rejected:
                fail("breakdown: the runtime could not admit the requests")

    def decode4() -> None:
        for _ in range(4):
            rt.decode()

    def drain() -> None:
        while rt.decode() is not None:
            pass
        report = rt.check_invariants()
        if report["pool"]["live"] != 0 or report["slots_active"] != 0:
            fail(f"breakdown: blocks or slots still held: {report}")

    drain()
    reqs = fresh()
    pre_wall = wall_ms(lambda: admit(reqs))
    dec_wall = wall_ms(decode4)
    drain()
    reqs = fresh()
    pre = profiled(lambda: admit(reqs))
    dec = profiled(decode4)
    drain()
    per_group = -(-512 // scfg.prefill_chunk)
    res = {"prefill_admission": {"dispatches": 2 * per_group,
                                 "wall_ms": pre_wall, **pre},
           "decode_4_chunks": {"steps": 4 * scfg.decode_chunk,
                               "wall_ms": dec_wall, **dec}}
    return report_rounds("breakdown", res)


def report_rounds(label: str, res: Dict[str, Dict]) -> Dict[str, Dict]:
    """Add each round's profiler slowdown and idle share (1 - device busy /
    unprofiled host wall), print it, and fail when the device was busy
    longer than the host wall of the same work."""
    for name, r in res.items():
        r["profiler_slowdown"] = r["profiled_wall_ms"] / r["wall_ms"]
        if r["device_busy_ms"] is not None:
            r["idle_share"] = 1.0 - r["device_busy_ms"] / r["wall_ms"]
        print(f"{label} {name}: {json.dumps(r)}")
        if r.get("idle_share", 0.0) < 0.0:
            fail(f"{label} {name}: device busy {r['device_busy_ms']} ms "
                 f"exceeds the host wall {r['wall_ms']} ms of the same work")
    return res


# ----------------------------------------------------------- 5. warm functions
def launcher_phase(cfg, params, device: Dict) -> Dict:
    from repro_torch import kernels
    from repro_torch.core.lora import partition_lora, tree_leaves
    from repro_torch.launch import serve as launcher

    t0 = phase("phase 5: warm-function launcher, Llama-2-7B full width on "
               "the card")
    argv = ["--adapters", str(LAUNCH["adapters"]),
            "--requests", str(LAUNCH["requests"]),
            "--prompt-len", str(LAUNCH["prompt_len"]),
            "--max-new", str(LAUNCH["max_new"]),
            "--rate", str(LAUNCH["rate"]), "--full"]
    args = launcher.build_parser().parse_args(argv)
    print(f"launcher flags: {' '.join(argv)} (device {args.device}); ring "
          f"of {LAUNCH_CONTEXT} slots per layer")
    torch.cuda.reset_peak_memory_stats()
    with FiniteLogits() as finite:
        kernels.reset_launches()
        res = launcher.serve(cfg, params, args)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()

    new = LAUNCH["max_new"]
    sizes = [b for _, b in res["schedule"]]
    if res["served"] != LAUNCH["requests"] or sum(sizes) != res["served"]:
        fail(f"served {res['served']} of {LAUNCH['requests']} requests")
    if res["shapes"] != [(b, new) for b in sizes]:
        fail(f"output shapes {res['shapes']} != (batch, {new})")
    if not finite.ok():
        fail("non-finite logits in the launcher run")
    if res["open_handles"] != LAUNCH["adapters"]:
        fail(f"store reported {res['open_handles']} open handles")
    own = [t.data_ptr() for t in tree_leaves(partition_lora(params)[0])]
    if any(ptrs != own for ptrs in res["backbone_ptrs"]):
        fail("a function's handle does not read the shared backbone")
    if LAUNCH_BATCH != max(sizes):
        fail(f"phase 3 timed {LAUNCH_BATCH} rows; the launcher's largest "
             f"batch was {max(sizes)}")
    L, sites, calls = cfg.num_layers, len(cfg.lora.targets), len(sizes)
    steps = calls * (new - 1)
    expected = {"flash_attention": L * calls,
                "decode_attention": L * steps,
                "sgmv": sites * L * (calls + steps),
                "paged_attention": 0, "paged_prefill": 0}
    print(f"launches {launches}, expected {expected} ({calls} prefill "
          f"calls, {steps} decode steps, {L} layers, {sites} LoRA sites)")
    if launches != expected or res["launches"] != expected:
        fail("launch counts differ from layers x calls x sites")
    tokens_per_s = res["tokens"] / res["wall_s"]
    print(f"batches {sizes}; {res['tokens']} tokens in "
          f"{res['wall_s']:.2f} s: {tokens_per_s:.1f} tokens/s (host clock) "
          f"on {device['kind']} [{'; '.join(device['nvidia_smi'])}]")
    out = {"schedule": res["schedule"], "requests": res["served"],
           "tokens": res["tokens"], "wall_s": res["wall_s"],
           "tokens_per_s": tokens_per_s, "prefill_calls": calls,
           "decode_steps": steps, "launches": launches,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    out["breakdown"] = engine_breakdown(cfg, params, device)
    torch.cuda.empty_cache()
    print(f"phase 5 ok ({time.perf_counter() - t0:.1f} s)")
    return out


def engine_breakdown(cfg, params, device: Dict, steps: int = 16) -> Dict:
    """Where one warm batch's time goes: a prefill of LAUNCH_BATCH fresh
    prompts and ``steps`` greedy decode steps, first on the host clock
    alone, then again from the same state (a fresh cache, the same prompts)
    under the profiler for device busy.  Idle share = 1 - device busy /
    unprofiled host wall; a busy time above that wall fails."""
    from repro_torch.core.engine import InferenceEngine
    eng = InferenceEngine(cfg, params, max_context=LAUNCH_CONTEXT)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    B, T = LAUNCH_BATCH, LAUNCH["prompt_len"]
    prompts = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                            device="cuda", dtype=torch.int32)
    ai = (torch.arange(B, device="cuda") % ADAPTERS).to(torch.int32)
    state: Dict = {}

    def prefill() -> None:
        logits, state["cache"] = eng.prefill(prompts, ai)
        state["tok"] = torch.argmax(logits, dim=-1).to(torch.int32)

    def decode() -> None:
        tok, cache = state["tok"], state["cache"]
        for i in range(steps):
            logits, cache = eng.decode_one(tok, cache, T + i, ai)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)

    res = {"prefill": {"rows": B, "tokens": T, "wall_ms": wall_ms(prefill)},
           "decode": {"rows": B, "steps": steps, "wall_ms": wall_ms(decode)}}
    res["prefill"].update(profiled(prefill))
    res["decode"].update(profiled(decode))
    report_rounds("engine breakdown", res)
    d = res["decode"]
    busy = d["device_busy_ms"]
    print(f"decode step, {B} rows at positions {T}-{T + steps - 1}: host "
          f"wall {d['wall_ms'] / steps:.2f} ms against device busy "
          + (f"{busy / steps:.2f} ms" if busy is not None
             else "not measured")
          + f" on {device['kind']} [{'; '.join(device['nvidia_smi'])}]")
    return res


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _to(tree, device: str):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


class StepClock:
    """Deterministic clock (each reading advances by 1e-4): the two
    replays of phase 5 then take the same scheduling decisions."""

    def __init__(self) -> None:
        self.calls = 0

    def __call__(self) -> float:
        self.calls += 1
        return self.calls * 1e-4


# --------------------------------------------------------------- 6. parity
def parity_phase() -> Dict:
    from repro_torch import kernels
    from repro_torch.configs import get_smoke
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.sampling import SamplingParams
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import LoRAConfig
    from repro_torch.serving import (ContinuousRuntime, ServingConfig,
                                     replay_trace)

    t0 = phase("phase 6: SMOKE float32, card (kernels) vs CPU (plain "
               "versions): runtime replay, greedy and sampled; engine "
               "generate")
    cfg = get_smoke("llama2_7b").with_(
        dtype="float32", lora=LoRAConfig(rank=8, alpha=16.0,
                                         num_adapters=3))
    gen = torch.Generator()
    gen.manual_seed(1)
    params = tf.init_params(cfg, gen, "cpu", lora_adapters=3,
                            lora_b_scale=0.1)
    scfg = dict(num_slots=4, block_size=8, num_blocks=24,
                max_blocks_per_slot=6, prefill_chunk=16, decode_chunk=4)
    work, prompts, fn_adapter = shared_prefix_trace(
        9, 3, 16, 30, 8, cfg.vocab_size, seed=7)
    # two sampled requests take the sort/top-k/top-p/Philox path; the rest
    # stay greedy
    sampling = {1: SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                                  seed=5),
                4: SamplingParams(temperature=1.0, seed=11)}
    sinks, results = {}, {}
    for device in ("cuda", "cpu"):
        rt = ContinuousRuntime(cfg, _to(params, device),
                               ServingConfig(**scfg), device=device,
                               timer=StepClock())
        kernels.reset_launches()
        sinks[device] = {}
        res, _ = replay_trace(rt, work, fn_adapter, prompts=prompts,
                              token_sink=sinks[device], sampling=sampling)
        results[device] = {
            "launches": kernels.launch_counts(),
            "admitted": sorted(r.req_id for r in res.requests
                               if r.first_token >= 0),
            "stall_steps": rt.stats["stall_steps"],
            "sampled_tokens": rt.stats["sampled_tokens"]}
    if results["cuda"]["sampled_tokens"] != 2 * 8:
        fail(f"expected 16 sampled tokens, the card drew "
             f"{results['cuda']['sampled_tokens']}")
    runtime_kernels = ("sgmv", "paged_attention", "paged_prefill")
    card = results["cuda"]["launches"]
    if min(card[k] for k in runtime_kernels) <= 0 or \
            card["flash_attention"] or card["decode_attention"] or \
            max(results["cpu"]["launches"].values()) != 0:
        fail(f"launches: card {results['cuda']['launches']}, CPU "
             f"{results['cpu']['launches']}")
    if results["cuda"]["admitted"] != results["cpu"]["admitted"]:
        fail(f"admitted sets differ: {results}")
    if sinks["cuda"] != sinks["cpu"]:
        diff = [k for k in sinks["cpu"]
                if sinks["cuda"].get(k) != sinks["cpu"][k]]
        fail(f"token streams differ for requests {diff} (sampled: "
             f"{sorted(sampling)})")
    n = sum(len(v) for v in sinks["cpu"].values())
    print(f"{len(sinks['cpu'])} requests, {n} tokens ("
          f"{results['cuda']['sampled_tokens']} sampled) equal on card "
          f"and CPU; stall steps {results['cuda']['stall_steps']}; card "
          f"launches {results['cuda']['launches']}")

    # the warm-function engine: 3 rows, one adapter each, 8 greedy tokens
    B, T, new = 3, 24, 8
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32))
    engine = {}
    for device in ("cuda", "cpu"):
        eng = InferenceEngine(cfg, _to(params, device), max_context=40,
                              device=device)
        kernels.reset_launches()
        out, _ = eng.generate(toks.to(device), new,
                              adapter_idx=torch.arange(
                                  B, dtype=torch.int32, device=device))
        engine[device] = {"tokens": out.cpu().tolist(),
                          "launches": kernels.launch_counts()}
    L = cfg.num_layers
    want = {"flash_attention": L, "decode_attention": L * (new - 1),
            "sgmv": len(cfg.lora.targets) * L * new, "paged_attention": 0,
            "paged_prefill": 0}
    if engine["cuda"]["launches"] != want or \
            max(engine["cpu"]["launches"].values()) != 0:
        fail(f"engine launches: card {engine['cuda']['launches']} "
             f"(expected {want}), CPU {engine['cpu']['launches']}")
    if engine["cuda"]["tokens"] != engine["cpu"]["tokens"]:
        fail(f"engine tokens differ: card {engine['cuda']['tokens']}, CPU "
             f"{engine['cpu']['tokens']}")
    print(f"engine generate: {B} rows x {new} greedy tokens equal on card "
          f"and CPU; card launches {engine['cuda']['launches']}")
    print(f"phase 6 ok ({time.perf_counter() - t0:.1f} s)")
    return {"requests": len(sinks["cpu"]), "tokens": n, **results["cuda"],
            "engine": engine["cuda"]}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    device = device_phase()
    build = build_phase()
    kern = kernels_phase()
    cfg, params = model_params()
    serve = serve_phase(cfg, params)
    launch = launcher_phase(cfg, params, device)
    del params
    torch.cuda.empty_cache()
    parity = parity_phase()

    line = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        k = kern["summary"][name]
        # each kernel's count comes from the path that runs it
        path = launch if name in ("flash_attention", "decode_attention") \
            else serve
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": path["launches"][name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(
            {"device": device, "build": build, "kernels": kern["cases"],
             "serve": serve, "launcher": launch, "parity": parity,
             "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
