#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py [--report PATH]

Run it from the root of a checkout.  It builds the port's CUDA kernels
from ``src/repro_torch/csrc`` and drives ``src/repro_torch``; it imports
neither JAX nor the JAX package.  Phases, each fatal on failure:

1. device: ``torch.cuda.get_device_name(0)``, the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line, the driver's version
   and nvcc's release;
2. build: compile the kernels with nvcc for sm_90a; print ptxas's
   registers and spills of the tensor-core (bf16) prefill kernels and of
   the float32 flash and paged prefill at hd 192 and 256, and the
   registers, static and dynamic shared memory and spills of the split-KV
   (float32) decode instantiations, of the bf16 decode step of ring and
   paged decode and of the SGMV kernels; fail on any spill;
3. kernels: each of the five hand-written kernels against its plain
   PyTorch version at the shapes the two serving paths give it at the
   widths of Llama-2-7B, in bfloat16 and float32 (and bfloat16 GQA and
   window cases of flash, ring decode, paged decode and paged prefill,
   paged decode at block sizes 4, 6, 8 and 12 and with NaN / Inf in every
   masked slot of its blocks and in the garbage block (each paged decode
   call also profiled: one kernel and one allocation in bf16, the
   partitions, their merge and four allocations in float32),
   SGMV at the row layouts of the two prefills, Mixtral-8x22B's shapes,
   and, timed in both dtypes, paged decode and prefill at
   RecurrentGemma-9B's hd 256 and G = 16 and at Nemotron-4-340B's hd 192
   and G = 12, flash at hd 192 / G = 12, at hd 256 / G = 8 behind a
   256-key image prefix and at hd 256 / G = 16 with a 2048-key window,
   ring decode at the same three head shapes, SGMV at Mamba2-780M's
   and Nemotron-4-340B's sites, and Whisper-medium's 1500 encoder keys:
   flash not causal over 1500 x 1500 and 32 x 1500, ring decode over 1500
   static slots, and phase 17's: flash causal over one row of 32768
   tokens, whose plain version runs by blocks of query rows, and ring
   decode of two rows over 32768 slots; then flash with a query offset,
   a sharded ring prefill's chunk, at Phi-3-medium-14B's heads (K 10,
   G 4, hd 128): 2 rows over 4096 keys, chunks of 512 queries at
   offsets 0, 1536 and 3584 and one under a 1000-key window, each over
   the keys up to its last query, in both dtypes, and each chunk's rows
   held against the same rows of one call over all 4096 queries: bit
   for bit where they are (offsets a multiple of 64 / G line up the
   tiles and stages), else within the tolerance), each bound from the wrapper
   module's ``work()``, which the dry run's kernel FLOPs read too,
   with its median device time, the plain version's, a library yardstick
   where one PyTorch call computes the same function, the least time the
   card could take for the work (``bound_ms``) and the share of it the
   kernel reaches (``bound_share`` = bound_ms / ms); then each attention
   wrapper must refuse a ``q``, and SGMV an ``x``, one element off a
   16-byte boundary;
4. serve: ``ContinuousRuntime`` + ``replay_trace`` at the full width of
   Llama-2-7B (random weights from a seed, a 4-adapter LoRA bank preloaded
   into an ``AdapterRegistry`` as fn0-fn3, a shared-prefix multi-adapter
   trace that names them), with both dispatches captured once as CUDA
   graphs, under ``CompileGuard({decode: 1, prefill: 1})``.  Every request
   must finish, the books must balance, no logit or pool entry may be
   non-finite, and every kernel's launch count must equal layers x
   dispatches x sites (replays counted).  Then adapter churn inside the
   guard: fn3 unloaded, fn3b (drawn from seed 1) loaded into its slot,
   four requests on fn3b and two on fn0 replayed; their tokens must equal
   those of a second runtime over the same backbone whose bank held fn3b
   from the start, and no LoRA leaf may move (``data_ptr``).  The first
   round's trace then runs again on a runtime whose dispatches run eagerly
   (``GraphedDispatch.eager``): equal greedy tokens, and a decode step's
   logits, captured and eager, within a stated tolerance.  A breakdown
   follows: one prefill admission and four decode chunks timed on the host
   clock, then the same round again, from the same state on fresh prompts
   of the same lengths, under ``torch.profiler`` for the device's busy
   time by kind (hence its idle share), with the profiler's kernel counts
   held against the wrappers' launch counts;
5. warm functions: the launcher ``repro_torch.launch.serve`` on the same
   weights (``BackboneStore`` + one ``FunctionInstance`` per adapter, the
   adaptive ``BatchingScheduler``, ``InferenceEngine.generate`` over ring
   caches, its decode step captured once per batch size): 32 requests of
   500 prompt tokens and 32 new tokens.  Every request must be served, no
   logit may be non-finite, the four handles must read the very backbone
   tensors, and the launch counts must equal layers x (prefill calls |
   decode steps) x sites.  One batch's captured tokens must equal an eager
   loop's.  Then its prefill and decode steps are timed on the host clock
   and, from the same state, under ``torch.profiler`` (device busy, hence
   idle share);
6. overload: the serving runtime on the same weights over a pool too
   small for its slots (160 blocks where 8 full slots need ~290), with
   preemption on (retry budget 3, backoff 50 ms) and a ``FaultPlan`` (a
   32-block pool squeeze, decode dispatches slowed x3 on the replay clock,
   and one failed adapter load at setup that the registry's retry
   recovers), under ``CompileGuard({decode: 1, prefill: 1})``: a burst of
   24 greedy requests from three tenants (one of SLO class 1 with a
   finite TTFT deadline), then two requests whose 1 ms TTFT deadline is
   provably unmeetable.  Every request must end in exactly one terminal
   state, the books must balance, every fault must fire, preemption and
   resume through the prefix cache must happen (each resume with a hit
   recomputing fewer prompt tokens than its prompt), exactly the two 1 ms
   requests must be shed, each finished request's tokens must equal its
   tokens on an ample pool with no faults, every demoted block must keep
   its contents until the pool reuses it, and the launch counts must equal
   layers x dispatches x sites.  Then ``abort`` on the same runtime: the
   aborted slot's blocks and pin are released, its completed blocks
   demoted, and the other request finishes with the tokens it gives alone;
7. parity: the SMOKE config in float32, replayed through the serving
   runtime on the card (kernels) and on the CPU (plain versions), must emit
   the same tokens, greedy and sampled (temperature, top-k, top-p), and
   the sampled rows' Philox uniforms must be equal bit for bit on the two
   devices; and ``InferenceEngine.generate`` on the two devices must emit
   the same greedy tokens; then the same for Mixtral SMOKE and Qwen2.5
   SMOKE (QKV bias), replays of RecurrentGemma SMOKE and Mamba2 SMOKE
   (state rows) and their ``generate`` over ring state, PaliGemma
   SMOKE's ``generate`` behind an image prefix (``make_prefill_step(
   embeds=)`` and captured decode steps) and Whisper SMOKE's over frame
   embeddings (``generate(frame_embeds=)``: encoder, cross caches);
8. Mixtral-8x22B at full width, its depth cut to 8 of 56 layers: window
   reclamation against its rule and against a run without it, the
   telemetry exporters, the breakdown beside its bound;
9. RecurrentGemma-9B at full width (hd 256, G = 16), its depth cut to 12
   of 38 layers (4 periods of REC, REC, ATTN), under ``CompileGuard({decode: 1, prefill: 1})``: 8 requests of
   2100-2600 prompt tokens past the 2048-key window, exact launch counts,
   ``reclaimed_blocks`` against the rule, tokens equal to an eager
   runtime's, 4 prompts again on recycled slots with equal tokens, the
   state rows of slots a decode chunk did not serve unchanged bit for
   bit, the sampling epilogue alone at vocab 256000, and the breakdown
   beside its bound;
10. Mamba2-780M at full width, its depth cut to 16 of 48 SSD layers: no
   pool block
   charged, exact SGMV launches, tokens equal to an eager runtime's, the
   breakdown beside its bound (weights plus the state rows read and
   written);
   phases 9 and 10 then also serve their model through
   ``InferenceEngine.generate`` over ring caches on the same weights
   (RecurrentGemma: 4 rows of 2112 prompt tokens, past its 2048-slot
   ring; Mamba2: 4 rows of 1024; 32 new tokens): one capture per batch
   size, exact flash and ring-decode launches, tokens equal to an
   uncaptured decode loop's;
11. Nemotron-4-340B at full width (LayerNorm, squared-ReLU MLP, 96 query
   heads over 8 kv heads of 192, vocab 256000 untied), its depth cut to 4
   of 96 layers, through the captured runtime: 8 requests of 1000-2000
   prompt tokens, 32 output tokens; ``CompileGuard`` {1, 1}, exact
   launches, tokens equal to an eager runtime's, the breakdown beside its
   bound;
12. PaliGemma-3B at full width and depth: 4 rows of 256 random patch
   embeddings and 256 text tokens through ``make_prefill_step(embeds=)``
   and 31 captured ring decode steps (exact launches, tokens equal to an
   uncaptured loop's), then 8 text-only requests through the captured
   runtime;
13. the warm-function launcher (``launch/serve.py --full --requests 8
   --prompt-len 256 --max-new 16``) at full width and depth on
   Qwen2.5-3B, SmolLM-360M, Phi-3-medium-14B and Llama-2-13B: one capture
   per batch size, exact launches, a batch's tokens equal to an
   uncaptured decode loop's;
14. a LoRA function's cold start at Llama-2-7B's full width, stage by
   stage as the reference's ``Simulator._dispatch`` charges it, each
   timing repeated 3 times: ``library_load`` and ``runtime_init`` in
   fresh processes (with the device memory of a process's CUDA context);
   ``kernel_compile`` (the kernel library's load, the first prefill's
   excess, a batch-1 decode-step capture); ``backbone_load`` with
   ``serverless/loading.py::pipelined_device_put`` from one pinned
   HOST-tier buffer and from pageable memory through its staging ring,
   beside a per-leaf ``.to("cuda")``, the PCIe bound and the ring's
   overlap, every leaf equal bit for bit; ``adapter_load``; then the
   first function cold (``BackboneStore`` over the loaded tree, a
   ``FunctionInstance`` with its loaded adapter, a batch from the
   fill-or-expire queue through ``InferenceEngine.generate``: exact
   launches, tokens equal to the drawn tree's), its cold TTFT against the
   warm one, a second function on the same backbone (shared
   ``data_ptr``s, its device memory within its adapter, rings and the
   first engine's extra state), a captured engine dropped and rebuilt in
   one process (equal tokens, every replayed launch seen by the
   profiler), and the port's ``Simulator`` over ``tests/test_system.py``'s
   paper setup under ``SLICE_HW`` and under the measured stages
   (simulator outputs, not gated);
15. Whisper-medium at full width and depth (24 encoder and 24 decoder
   layers, 1.62 GB) through ``InferenceEngine.generate(frame_embeds=)``:
   4 rows of 1500 random frame embeddings and 32-token prompts, one
   adapter a row, 64 new tokens, then the first row alone (a second
   capture): exact launches (flash 72 per prefill call, ring decode 48
   and SGMV 96 per decode step), tokens equal to an uncaptured decode
   loop's, no non-finite logit, the rows' cross caches pairwise
   different; then one prefill call and 16 captured decode steps under
   the profiler, beside their bounds;
16. LoRA fine-tuning, which calls no kernel: a LoRA train step of every
   config's SMOKE model in float32 on the card and on the CPU (the loss,
   every adapter leaf's gradient, each nonzero, and the updated
   adapters within stated tolerances); each of the five kernel wrappers
   refusing a grad-requiring CUDA input; then Llama-2-7B at full width
   and depth through ``launch/train.py``'s code path (batch 4 x 1024
   tokens of the synthetic corpus, remat, 20 steps at the launcher's
   rate): finite losses, the backbone's tensors at their addresses with
   their bits and no ``.grad``, every adapter leaf moved, no kernel
   launched, one step at a small rate lowering its batch's loss, each
   step's host wall, one step profiled by op kind, peak memory and
   tokens/s beside the step's bound; the trained adapter saved and read
   back bit for bit, loaded into an ``AdapterRegistry`` and served;
17. the multi-device launch layer (``launch/{mesh,sharding,specs,
   dryrun}.py``, ``launch/train.py --mesh``, the shard-local MoE).
   17a, on the host in a child process at the lowest CPU priority,
   started before phase 8 and running beside phases 8-17: the dry run over
   the fake 16x16 and 2x16x16 worlds (meta tensors as DTensors):
   Llama-2-7B x the four shapes, Mixtral-8x22B x the four shapes
   (OPTIMIZED) and Nemotron-4-340B decode_32k on both meshes, and
   Llama-2-7B's and Nemotron-4-340B's decode_32k under OPTIMIZED,
   Mixtral-8x22B's decode_32k (BASELINE) and Phi-3-medium-14B's
   prefill_32k on 16x16; the
   argument bytes must equal the reference's arithmetic (``DRYRUN_GB``),
   and Llama-2-7B's per-device FLOPs of its train, prefill and decode
   steps times the devices must be within ``DRYRUN_FLOPS_TOL`` of the
   hand count ``dryrun.analytic_flops`` (no device repeating another's
   work); Nemotron-4-340B's decode_32k runs must be within
   ``DRYRUN_NEMOTRON_MAX`` of it (its ring is split on head_dim or the
   sequence, and each model rank takes its share of the attention);
   Mixtral-8x22B's decode_32k (BASELINE and OPTIMIZED: the dropless
   math, its experts left where they are stored) and Phi-3-medium-14B's
   prefill_32k (its ring prefill split on the queries) within
   ``DRYRUN_FLOPS_TOL`` of theirs; every other run with a hand count
   prints its ratio.
   17b: ``build_step``'s prefill and serve steps of Llama-2-7B at full
   width and depth as DTensors on a one-rank NCCL mesh: one row of
   32768 tokens (flash causal at 32768), then 8 decode steps of two rows
   over a 32768-slot ring (the ring wrapped); logits within the bf16
   tolerance of, and greedy tokens equal to, the same steps on plain
   tensors; the args' ``memory_allocated`` against the dry run's
   argument bytes at these shapes; host wall, device time by kind, peak
   memory and each step's bound; flash and ring decode launched once a
   layer a step.  17c: ``launch/train.py --mesh 1x1`` with phase 16's
   arguments, 3 steps, each loss within 1e-3 of phase 16's.  17d:
   ``_apply_moe_parallel`` at Mixtral-8x22B's width (one MoE layer, 4 x
   512 tokens, both dispatches) against ``apply_moe``'s plain path,
   timed;
18. the examples (``repro_torch.examples``), run right after phase 6 on
   its weights, within 90 s.  18a: ``serve_continuous``'s work function
   at Llama-2-7B's full width and depth on the example's default trace
   (3 bursty functions at 2 requests/s for 15 s, 24-token prompts behind
   a 16-token shared prefix, 16 outputs; 8 slots, blocks of 8, 96 blocks,
   prefill chunk 16, decode chunk 4) with three random adapters loaded by
   name: every request in a terminal state, no block in use after the
   drain, ``CompileGuard({decode: 1, prefill: 1})``, prefix block maps,
   no non-finite logit and exact paged prefill, paged decode and SGMV
   launches; TTFT and TPOT p50 / p95, the host-bubble fraction and
   tokens/s printed.  18b: ``serve_multilora``'s work function on the
   same weights (24 requests over the 4 adapters, 16 new tokens): the
   measured T0, one capture per batch size, exact flash, ring-decode and
   SGMV launches.  18c: ``quickstart`` (exact launches; its simulator
   lines equal to a CPU run's), ``train_lora`` (its defaults, the
   checkpoint under ``build/``; no launch) and ``serverless_sim``
   through their ``main`` at the reference's SMOKE sizes, each example's
   own asserts holding.

Phases 8-17 each run in a child process of the script (``isolated``; one
child per model in phase 13; 17a and 17b-d in one each, 17a beside the
others).
``--report`` writes every number to a JSON file.  The model of phases 4,
5 and 6 runs at its full depth.  Each capture of a dispatch is preceded by one
eager run of it (``serving/graphs.py``), whose launches count.  The last
two lines of output are a ``{"kernels": [...]}`` object and ``{"ok":
true, "device": {...}}``.
Without a CUDA card, or outside a checkout, the script exits nonzero and
prints no result.
"""
from __future__ import annotations

import argparse
import functools
import gc
import json
import math
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent

# H100 SXM, NVIDIA data sheet (dense rates, 700 W): HBM3 bytes/s, and the
# peak rate for each operand type — bf16 on the tensor cores, float32 on
# the CUDA cores (no TF32).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version: max |diff| <= TOL * max(1, max |plain|), and in
# every output row (the last axis: a head's hd values, an SGMV row's O) the
# RMS of the difference <= TOL * the row's RMS, so that rows far smaller
# than the largest (flash rows over 2048 keys beside row 0 over one) are
# held at their own scale.  Both sides compute in float32; float32 differs
# only in summation order, and bfloat16 outputs may round one unit (2^-8
# relative) apart: 2^-7 allows two.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
SLEEP_CYCLES = 2_000_000     # ~1 ms of device sleep ahead of a timed launch
MARKERS = 512                # spin kernels around a profiled run (F7)
PROFILER_SETTLE_S = 0.25     # wait after a profiler session starts (F7)
PROFILE_ATTEMPTS = 3         # a profiled round and two more where it lost
RING_LSE_TOL = 1e-3          # ring decode's log-sum-exp against the plain
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
# Phase 3's paged kernels at other block sizes: 4 and 12 (pieces of a
# stage of 4 keys: paged prefill copies them key by key, paged decode by
# TMA boxes that start part way into the swizzle's period), 6 (paged
# decode's boxes of 2 rows) and 8, phase 18a's (serve_continuous);
# Llama-2-7B's history of up to 768 keys
SMALL_BLOCK_SERVE = {bs: dict(SERVE, block_size=bs,
                              max_blocks_per_slot=-(-MAX_PROMPT // bs))
                     for bs in (4, 6, 8, 12)}

# Phase 5: the warm-function launcher's flags.  Its scheduler forms
# batches of 1-3 rows at these flags; phase 3 times the ring-engine kernels
# at the largest, LAUNCH_BATCH rows.
LAUNCH = dict(adapters=4, requests=32, prompt_len=500, max_new=32, rate=50.0)
LAUNCH_BATCH = 3
LAUNCH_CONTEXT = LAUNCH["prompt_len"] + LAUNCH["max_new"] + 8   # ring S

# Phase 6: overload.  The pool holds 160 blocks (8 MB each at these widths)
# where 8 slots of these prompts need ~290, and the squeeze takes 32 more
# while it is open.  Windows are on the replay clock, in seconds.
OVERLOAD = dict(SERVE, num_blocks=160)
OVERLOAD_ROBUST = dict(preemption=True, retry_budget=3, backoff_s=0.05)
TENANTS = {"premium": "fn0", "std": "fn1", "bulk": "fn3"}   # -> adapter
OVERLOAD_REQUESTS = 24
OVERLOAD_PROMPT = (256, 744)
OVERLOAD_OUTPUT = 64
OVERLOAD_BURST_S = 0.1
# set where no wait of this phase can provably miss it: the shed set is
# then exactly the two 1 ms requests; attainment is also read against the
# reference's 2.5 s TTFT SLO (serverless/traces.py TraceSpec.slo_ttft)
PREMIUM_DEADLINE_S = 30.0
TTFT_SLO_S = 2.5
DOOMED = 2                   # requests with a 1 ms TTFT deadline
DOOMED_ARRIVAL_S = 0.5       # after the first prefill has been timed
# The replay admits a whole burst between two boundaries of the plan, so
# the squeeze window reaches past the longest first burst: the squeeze
# then takes what admission left, and every slot stalls
SQUEEZE = dict(t0=0.2, t1=3.0, blocks=32)
SLOWDOWN = dict(t0=0.3, t1=3.0, factor=3.0, kind="decode")
PROFILED_CHUNKS = range(24, 28)   # decode chunks of the replay profiled

# Phase 8: Mixtral-8x22B at full width, depth cut from 56 to 8 layers (56
# layers of bf16 weights are ~281 GB; 8 are 40.9 GB).  A pool block holds
# 16 tokens x 8 kv heads x 128 x K and V: 64 KB per layer, so 2560 blocks
# are 1.34 GB over 8 layers; 304 blocks per slot hold 4864 tokens.
MIXTRAL = "mixtral_8x22b"
MIXTRAL_LAYERS = 8
MIXTRAL_SERVE = dict(num_slots=8, block_size=16, num_blocks=2560,
                     max_blocks_per_slot=304, prefill_chunk=64,
                     prefill_rows=4, decode_chunk=4)
MIXTRAL_REQUESTS = 8         # 2 per adapter, arrivals 20 ms apart
MIXTRAL_PROMPT = (4200, 4700)     # past the 4096-key window
MIXTRAL_OUTPUT = 64          # every slot decodes across the window
MIXTRAL_BREAKDOWN_PROMPT = 4160   # 65 chunks: history up to the window

# Phase 9: RecurrentGemma-9B at full width, its depth cut from 38 to 12
# layers (4 whole periods of REC, REC, ATTN) to keep the script inside its
# time limit.  Its ATTN layers page 16 tokens x 1 kv head x 256 x K and V:
# 16 KB per block per layer, so 1400 blocks are 90 MB over the 4 layers;
# 168 blocks per slot hold 2688 tokens.  The REC layers keep 41 KB of
# state rows per slot a layer.
RGEMMA = "recurrentgemma_9b"
RGEMMA_LAYERS = 12
RGEMMA_SERVE = dict(num_slots=8, block_size=16, num_blocks=1400,
                    max_blocks_per_slot=168, prefill_chunk=64,
                    prefill_rows=4, decode_chunk=4)
RGEMMA_PROMPT = (2100, 2600)      # past the 2048-key window
RGEMMA_OUTPUT = 64
RGEMMA_REPEAT = 4                 # first-wave prompts served again
RGEMMA_BREAKDOWN_PROMPT = 2112    # 33 chunks: history past the window

# Phase 10: Mamba2-780M at full width, its depth cut from 48 to 16 SSD
# layers to keep the script inside its time limit; attention-free: no pool
# block is charged (the pool only holds its garbage block), and a slot's
# state rows are 1.59 MB a layer.
MAMBA = "mamba2_780m"
MAMBA_LAYERS = 16
MAMBA_SERVE = dict(num_slots=8, block_size=16, num_blocks=8,
                   max_blocks_per_slot=4, prefill_chunk=64, prefill_rows=4,
                   decode_chunk=4)
MAMBA_PROMPT = (1000, 4000)
MAMBA_OUTPUT = 64
MAMBA_BREAKDOWN_PROMPT = 1024

# The warm-function engine on phases 9 and 10's weights: rows, prompt
# tokens (RecurrentGemma's past its 2048-slot ring) and new tokens.
RING_ROWS = 4
RGEMMA_RING_PROMPT = 2112
MAMBA_RING_PROMPT = 1024
RING_NEW = 32

# Phase 11: Nemotron-4-340B at full width, depth cut from 96 to 4 layers
# (a layer is 3.45 B parameters, 6.9 GB of bf16; with the 9.4 GB embedding
# and 9.4 GB LM head, 4 layers are 46.5 GB).  A pool block holds 16
# tokens x 8 kv heads x 192 x K and V: 96 KB per layer, so 1100 blocks are
# 433 MB over 4 layers; 132 blocks per slot hold 2112 tokens.
NEMOTRON = "nemotron_4_340b"
NEMOTRON_LAYERS = 4
NEMOTRON_SERVE = dict(num_slots=8, block_size=16, num_blocks=1100,
                      max_blocks_per_slot=132, prefill_chunk=64,
                      prefill_rows=4, decode_chunk=4)
NEMOTRON_PROMPT = (1000, 2000)
NEMOTRON_OUTPUT = 32
NEMOTRON_BREAKDOWN_PROMPT = 1024

# Phase 12: PaliGemma-3B at full width and depth (18 layers, 8 query heads
# over 1 kv head of 256, vocab 257216 tied, 5.0 GB).  The
# warm path: 4 rows of 256 patch embeddings (the reference's stub
# frontend: random, at the token embeddings' N(0, 0.02) scale) and 256
# text tokens, 32 new tokens; the runtime: text-only prompts.
PALIGEMMA = "paligemma_3b"
PALI_ROWS, PALI_TEXT, PALI_NEW = 4, 256, 32
PALI_SERVE = dict(num_slots=8, block_size=16, num_blocks=400,
                  max_blocks_per_slot=40, prefill_chunk=64, prefill_rows=4,
                  decode_chunk=4)
PALI_PROMPT = (256, 512)
PALI_OUTPUT = 32

# Phase 13: the launcher at full width and depth on four decoders, one
# child process each.
ZOO_LAUNCH = ("qwen2_5_3b", "smollm_360m", "phi3_medium_14b", "llama2_13b")
ZOO_PROMPT, ZOO_NEW = 256, 16
ZOO_ROWS = 8                 # the launcher's largest batch (max_batch)
ZOO_FLAGS = ["--full", "--requests", "8", "--prompt-len", str(ZOO_PROMPT),
             "--max-new", str(ZOO_NEW)]

# Phase 14: a LoRA function's cold start at Llama-2-7B's full width, stage
# by stage, each timing repeated COLD_REPEATS times; the cold batch is
# phase 5's prompt length, COLD_FNS the adapters of the two functions.
COLD_REPEATS = 3
COLD = dict(rows=4, prompt_len=500, max_new=16)
COLD_FNS = (1, 2)
PCIE_GT_S = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0, 6: 64.0}

# Phase 15: Whisper-medium at full width and depth (24 encoder + 24
# decoder layers, 16 heads x 64, 1.62 GB) on the warm-function path: 4
# rows of 1500 random frame embeddings (the reference's stub frontend),
# 32-token prompts and 64 new tokens (inside real Whisper's 448-token
# decoder context), then one row alone; breakdown decode steps.
WHISPER = "whisper_medium"
WHISPER_ROWS, WHISPER_PROMPT, WHISPER_NEW = 4, 32, 64
WHISPER_STEPS = 16

# Phase 16: LoRA fine-tuning of Llama-2-7B at full width and depth
# through launch/train.py's code path (rank-16 adapters on q/k/v/o, the
# launcher's lr 5e-3 on its cosine schedule, remat per layer), then one
# step at TRAIN_SMALL_LR on a batch of its own; the SMOKE card-vs-CPU
# steps of every config at SMOKE_TRAIN_LR.  Tolerances, card (float32,
# no TF32) against the CPU: the loss within 1e-5 x max(1, |CPU|), each
# gradient leaf within TRAIN_GRAD_TOL x its largest CPU element, and each
# updated adapter element within what its gradient's difference allows
# a first AdamW step (``smoke_train_on_both``): an element whose gradient
# is near zero takes a normalised step that float32 noise can turn.
TRAIN_ARGS = ["--arch", "llama2_7b", "--full", "--batch", "4", "--seq",
              "1024", "--steps", "20", "--device", "cuda"]
TRAIN_SMALL_LR = 1e-4
SMOKE_TRAIN_LR = 1e-3
TRAIN_GRAD_TOL = 1e-4

# phase 17: the multi-device launch layer on one card.  17a: the dry run
# on the host over the fake 16x16 and 2x16x16 worlds (in a child process
# of its own, beside phases 8-17); 17b: build_step's prefill and serve steps of
# Llama-2-7B at full width and depth as DTensors on a one-rank NCCL mesh,
# at a reduced batch; 17c: the training launcher with --mesh 1x1; 17d:
# the shard-local MoE at Mixtral-8x22B's width.
SHARDED = "llama2_7b"
SHARDED_CONTEXT = 32768          # prefill_32k / decode_32k's sequence
SHARDED_PREFILL_ROWS = 1         # of prefill_32k's 32
SHARDED_DECODE_ROWS = 2          # of decode_32k's 128
SHARDED_DECODE_STEPS = 8
SHARDED_TRAIN_STEPS = 3
SHARDED_LOSS_RTOL = 1e-3
ALLOC_GRANULE = 512              # the caching allocator rounds each block
MOE_PARALLEL_ROWS, MOE_PARALLEL_TOKENS = 4, 512
# the dry runs executed, by mesh (multi_pod): (arch, shape, optimized).
# --all is not run: it takes about 14 minutes of host time on one pod
# (Mamba2-780M's prefill_32k alone 2 minutes), not the 120 s it would
# have to fit.
_DRYRUN_BOTH = [("llama2_7b", s, False) for s in
                ("train_4k", "prefill_32k", "decode_32k", "long_500k")] \
    + [("mixtral_8x22b", s, True) for s in
       ("train_4k", "prefill_32k", "decode_32k", "long_500k")] \
    + [("nemotron_4_340b", "decode_32k", False)]
DRYRUN_RUNS = {False: _DRYRUN_BOTH + [("llama2_7b", "decode_32k", True),
                                      ("nemotron_4_340b", "decode_32k", True),
                                      ("mixtral_8x22b", "decode_32k", False),
                                      ("phi3_medium_14b", "prefill_32k",
                                       False)],
               True: _DRYRUN_BOTH}
# FLOPs per device x devices over the hand count of Llama-2-7B's runs,
# Mixtral-8x22B's decode_32k (no device running rows it does not own
# through experts it does not hold: F12, 120x before) and
# Phi-3-medium-14B's prefill_32k (its heads and rows do not divide
# "model": the ring prefill splits the queries, F13, 5.95x before): at
# most this above 1 (rank-16 LoRA products on partial sums whose rows do
# not divide, and the router on every row at decode, are the rest)
DRYRUN_FLOPS_TOL = 0.03
DRYRUN_GATED = {("llama2_7b", s) for s in
                ("train_4k", "prefill_32k", "decode_32k")} | {
    ("mixtral_8x22b", "decode_32k"), ("phi3_medium_14b", "prefill_32k")}
# phase 3's flash chunks with a query offset (a sharded ring prefill's,
# ``layers._zigzag_prefill``) at Phi-3-medium-14B's heads: rows x keys,
# the chunk, and (offset, window) of each case
FLASH_OFFSET_ROWS, FLASH_OFFSET_KEYS, FLASH_OFFSET_CHUNK = 2, 4096, 512
FLASH_OFFSETS = ((0, None), (1536, None), (3584, None), (1536, 1000))
# Nemotron-4-340B decode_32k's ratio: its ring is split on head_dim (or
# the sequence) over "model", and each model rank must still take its
# share of the attention (F11: every rank ran it whole, 4.85x)
DRYRUN_NEMOTRON_MAX = 1.2
# per-device GB of weights and cache the reference's specs give its
# eval_shape args (byte counts, not measurements): (params, cache)
DRYRUN_GB = {("llama2_7b", "decode_32k", False, False): (0.087, 8.594),
             ("llama2_7b", "decode_32k", False, True): (0.876, 8.594),
             ("nemotron_4_340b", "decode_32k", False, False): (3.028, 9.676),
             ("nemotron_4_340b", "decode_32k", False, True): (22.138,
                                                              9.676)}

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
def setup() -> None:
    """A card and a checkout, or fail; the port on the path; float32
    products in full float32."""
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA "
             "card")
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             f"(no src/repro_torch/csrc)")
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def device_phase() -> Dict:
    setup()
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
    from repro_torch.kernels import cuda_lib
    drv = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=False)
    nvcc = subprocess.run([cuda_lib.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=False)
    release = [ln.strip() for ln in nvcc.stdout.splitlines()
               if "release" in ln]
    print(f"driver {drv.stdout.strip()}; nvcc: "
          f"{release[0] if release else nvcc.stdout.strip()}")
    print(f"phase 1 ok ({time.perf_counter() - t0:.1f} s)")
    return {"kind": name, "count": torch.cuda.device_count(),
            "nvidia_smi": lines, "driver": drv.stdout.strip(),
            "nvcc": release, "torch": torch.__version__}


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
    # the Hopper prefill steps (bf16: every head dim, one or two consumer
    # warpgroups, flash with and without the prefix rule), their merge,
    # and the float32 flash and paged prefill at hd 192 and 256:
    # registers and spills
    for u in usage:
        m = re.search(r"(flash_kernel|paged_prefill)_bf16ILi(\d+)ELi(\d)E"
                      r"(?:Lb([01])E)?", u["function"])
        if m:
            u["prefill"] = {"kernel": m[1].replace("_kernel", ""),
                            "hd": int(m[2]), "warpgroups": int(m[3]),
                            "prefix": m[4] == "1"}
            print(f"ptxas {u['prefill']['kernel']} bf16 hd {m[2]}, {m[3]} "
                  f"consumer warpgroup(s) ({64 * int(m[3])}-row tiles)"
                  + (", prefix rule" if m[4] == "1" else "")
                  + f": {u['registers']} registers a thread at launch "
                  f"(setmaxnreg moves the producer's to the consumers), "
                  f"spill stores {u.get('spill_stores')} B, spill loads "
                  f"{u.get('spill_loads')} B")
        elif "prefill_split_merge" in u["function"] or re.search(
                r"(flash_kernel|paged_prefill)_f32ILi(192|256)E",
                u["function"]):
            print(f"ptxas {u['function']}: {u['registers']} registers, "
                  f"spill stores {u.get('spill_stores')} B, spill loads "
                  f"{u.get('spill_loads')} B")
    # ptxas serialises a kernel's wgmma where it cannot keep them in
    # flight (a call, too few registers, an operand defined mid-pipeline)
    serial = sorted({ln.split("in the function")[1].strip(" '")[:120]
                     for ln in info.log.splitlines()
                     if "wgmma.mma_async instructions are serialized" in ln
                     and "in the function" in ln})
    print(f"ptxas: wgmma serialised in {len(serial)} functions")
    if serial:
        fail(f"ptxas serialised the wgmma of {serial}")
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
    # the bf16 decode step: ring decode (one instantiation per head dim)
    # and paged decode (per head dim, up to 8 or 16 query heads a CTA)
    for u in usage:
        m = re.search(r"(ring|paged)_decode_kernelILi(\d+)E(?:Li(\d+)E)?",
                      u["function"])
        if m:
            u["ring_step"] = {"kernel": f"{m[1]}_decode", "hd": int(m[2]),
                              "rows": int(m[3] or 8)}
            print(f"ptxas {m[1]} decode step bf16 hd {m[2]}, "
                  f"{m[3] or 8} heads a CTA: {u['registers']} "
                  f"registers, static smem {u['static_smem']} B, spill "
                  f"stores {u.get('spill_stores')} B, spill loads "
                  f"{u.get('spill_loads')} B")
    # SGMV: the bf16 cluster kernel and the float32 CUDA-core ones
    for u in usage:
        if "sgmv_" in u["function"]:
            print(f"ptxas {u['function']}: {u['registers']} registers, "
                  f"static smem {u['static_smem']} B, stack frame "
                  f"{u.get('stack_frame')} B, spill stores "
                  f"{u.get('spill_stores')} B, spill loads "
                  f"{u.get('spill_loads')} B")
    spilled = [u["function"] for u in usage
               if u.get("spill_stores", 0) or u.get("spill_loads", 0)]
    if spilled:
        fail(f"ptxas spilled registers in {spilled}")
    print(f"phase 2 ok: 0 bytes of spills in all {len(usage)} "
          f"instantiations ({time.perf_counter() - t0:.1f} s)")
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


def bound_of(work) -> Dict:
    """The bound of a kernel call from its wrapper module's ``work()``,
    the count the dry run's kernel FLOPs read too."""
    return bound(work.bytes, work.flops, work.dtype)


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
              adapters: int = ADAPTERS, D: int = 4096,
              O: int = 4096) -> Dict:
    """Rows in runs of ``run`` consecutive rows, run i carrying adapter
    i % ``adapters`` of a bank of ADAPTERS (run 1: interleaved, the worst
    case for the kernel's per-tile passes; the prefills send token-major
    runs of a request's length), the last row out of range.  D x O is a
    LoRA site's width: Llama-2-7B's 4096 x 4096 by default."""
    from repro_torch.kernels.sgmv import ops
    from repro_torch.kernels.sgmv.ref import sgmv_ref
    r, N = 16, ADAPTERS
    x = _randn(gen, R, D, dtype=dtype)
    a = _randn(gen, N, D, r, dtype=dtype, scale=1 / math.sqrt(D))
    b = _randn(gen, N, r, O, dtype=dtype, scale=0.02)
    idx = (torch.arange(R, device="cuda") // run % adapters).to(torch.int32)
    idx[-1] = N                            # out of range: an exact zero row
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
        kernel=lambda: ops.sgmv_apply(x, a, b, idx, scaling=2.0),
        plain=lambda: sgmv_ref(x, a, b, idx, scaling=2.0),
        library=library, library_label=label,
        zero_rows=[R - 1], **bound_of(ops.work(x, a, b, idx)))


def decode_case(gen, dtype, K: int = 32, G: int = 1,
                window: Optional[int] = None, serve: Dict = SERVE,
                positions=(SYSTEM_PROMPT, MAX_PROMPT + OUTPUT_TOKENS),
                reclaimed: bool = False, hd: int = 128,
                poison: bool = False) -> Dict:
    """Runtime decode: one token for each of ``num_slots`` rows over its
    paged history, at Llama-2-7B head widths by default (``H = K * G``
    query heads of ``hd``), rows at positions in [``positions``).  With
    ``reclaimed``, each live row's table holds -1 for every block that
    slid wholly out of the window, as the runtime's window reclamation
    leaves it.  With ``poison`` every masked slot of a block in a table
    (past its row's position, before its window) and the garbage block 0
    hold NaN in K and Inf in V for the kernel, zeros for the plain version
    and the yardstick."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    B = serve["num_slots"]
    NB, bs, MB = serve["num_blocks"], serve["block_size"], \
        serve["max_blocks_per_slot"]
    H = K * G
    kp = _randn(gen, K, NB, bs, hd, dtype=dtype)
    vp = _randn(gen, K, NB, bs, hd, dtype=dtype)
    q = _randn(gen, B, H, hd, dtype=dtype)
    pos = torch.randint(*positions, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[-1] = 0                            # an inactive slot ...
    tbl = paged_table(gen, B, MB, NB, pos // bs)
    tbl[-1] = -1                           # ... whose table is all -1
    tbl[1, 2] = -1                         # a hole inside a live row
    if reclaimed:
        dead = (pos - window + 1).clamp(min=0) // bs
        j = torch.arange(MB, device="cuda")
        tbl = torch.where(j[None] < dead[:, None], torch.full_like(tbl, -1),
                          tbl).contiguous()
    t = torch.arange(MB * bs, device="cuda")
    ok = (t[None] <= pos[:, None]) & (tbl[:, t // bs] >= 0)
    if window is not None:
        ok = ok & (t[None] > pos[:, None] - window)
    live = int(ok.sum())
    kk, vk = kp, vp                        # what the kernel reads
    if poison:
        blk = tbl[:, t // bs]
        bad = (blk >= 0) & ~ok
        phys, off = blk[bad].long(), t.expand_as(blk)[bad] % bs
        for pool in (kp, vp):
            pool[:, phys, off] = 0
            pool[:, 0] = 0
        kk, vk = kp.clone(), vp.clone()
        for pool, x in ((kk, float("nan")), (vk, float("inf"))):
            pool[:, phys, off] = x
            pool[:, 0] = x
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
              f"window={window} live_keys={live}"
              + (f" reclaimed_entries={int((tbl[:-1] < 0).sum())}"
                 if reclaimed else "")
              + (" masked=NaN/Inf" if poison else ""),
        kernel=lambda: ops.paged_decode_gqa(q, kk, vk, tbl, pos,
                                            window=window),
        plain=lambda: paged_attention_ref(q, kp, vp, tbl, pos,
                                          window=window),
        library=lambda: F.scaled_dot_product_attention(q4, kc, vc,
                                                       attn_mask=mask),
        library_label="scaled_dot_product_attention over K/V already "
                      "gathered contiguous"
                      + (", repeated per head" if G > 1 else ""),
        zero_rows=[B - 1],
        **bound_of(ops.work(q, kp, vp, tbl, pos, window=window)))


def prefill_case(gen, dtype, K: int = 32, G: int = 1,
                 window: Optional[int] = None, serve: Dict = SERVE,
                 starts=(0, MAX_PROMPT - SERVE["prefill_chunk"]),
                 hd: int = 128, parts: int = 1) -> Dict:
    """Runtime prefill: a chunk of ``prefill_chunk`` queries for each of
    ``prefill_rows`` rows over its paged history, at Llama-2-7B head
    widths by default (``H = K * G`` query heads of ``hd``), each chunk
    starting at a block boundary in [``starts``].  In bf16 the library's
    rule must split the walk into ``parts`` key partitions (the values
    tests/test_torch_prefill_tile_precision.py asserts of its copy)."""
    from repro_torch.kernels.paged_prefill.ops import (paged_prefill_gqa,
                                                       partitions, work)
    from repro_torch.kernels.paged_prefill.ref import paged_prefill_ref
    B, C = serve["prefill_rows"], serve["prefill_chunk"]
    NB, bs, MB = serve["num_blocks"], serve["block_size"], \
        serve["max_blocks_per_slot"]
    H = K * G
    S = 1
    if dtype == torch.bfloat16:
        S = partitions(B, C, K, G, bs, MB, hd, window,
                       torch.device("cuda", torch.cuda.current_device()))
        if S != parts:
            fail(f"paged prefill at B={B} C={C} K={K} G={G} hd={hd} bs={bs} "
                 f"MB={MB} window={window}: the library's rule gives {S} "
                 f"key partitions, expected {parts}")
    kp = _randn(gen, K, NB, bs, hd, dtype=dtype)
    vp = _randn(gen, K, NB, bs, hd, dtype=dtype)
    q = _randn(gen, B, C, H, hd, dtype=dtype)
    start = bs * torch.randint(starts[0] // bs, starts[1] // bs + 1, (B,),
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
              f"window={window} history_keys={keys} partitions={S}",
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
        **bound_of(work(q, kp, vp, tbl, q_pos, window=window)))


def flash_plain_by_rows(q, k, v, rows: int = 1024) -> torch.Tensor:
    """The plain version of causal flash attention (``flash_ref``'s
    arithmetic: float32 scores, ``masked_attention``) over ``rows`` query
    positions at a time, each block against the keys up to its last
    query: at 32768 tokens the whole score matrix would take 137 GB.
    q: (B, T, H, hd); k, v: (B, T, K, hd).  Returns (B, T, H, hd)."""
    from repro_torch.kernels.paged_attention.ref import masked_attention
    B, T, H, hd = q.shape
    K = k.shape[2]
    G = H // K
    out = torch.empty_like(q)
    kf = k.transpose(1, 2).float()                           # (B, K, T, hd)
    vf = v.transpose(1, 2).float()[:, :, None]
    for i0 in range(0, T, rows):
        i1 = min(T, i0 + rows)
        qg = q[:, i0:i1].transpose(1, 2).reshape(B, K, G, i1 - i0, hd)
        s = torch.einsum("bkgqh,bksh->bkgqs", qg.float(),
                         kf[:, :, :i1]) / math.sqrt(hd)
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        kp = torch.arange(i1, device=q.device)[None, :]
        o = masked_attention(s, kp <= qp, vf[:, :, :, :i1])
        out[:, i0:i1] = o.reshape(B, H, i1 - i0, hd).transpose(1, 2).to(
            q.dtype)
    return out


def flash_case(gen, dtype, B: int, T: int, K: int, G: int,
               window: Optional[int] = None, hd: int = 128,
               prefix: int = 0, Tk: Optional[int] = None,
               causal: bool = True) -> Dict:
    """Ring-engine prefill: causal attention of B rows of T tokens over
    their own keys, at Llama-2-7B head widths by default; the first
    ``prefix`` keys are visible to every query (a VLM's image prefix).
    Without ``causal``, T queries over ``Tk`` keys (T by default), every
    key visible: Whisper's encoder and cross-attention prefill.  Past
    4096 causal tokens the plain version runs by blocks of query rows
    (``flash_plain_by_rows``)."""
    from repro_torch.kernels.flash_attention.ops import flash_mha, work
    from repro_torch.kernels.flash_attention.ref import flash_ref
    H, Tk = K * G, T if Tk is None else Tk
    q = _randn(gen, B, T, H, hd, dtype=dtype)
    k = _randn(gen, B, Tk, K, hd, dtype=dtype)
    v = _randn(gen, B, Tk, K, hd, dtype=dtype)
    # library yardstick: SDPA over (B, H, T, hd) copies, K/V repeated to H
    # heads for GQA (the copies are not timed)
    q4 = q.transpose(1, 2).contiguous()
    k4 = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    v4 = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    if window is None and not prefix:
        library = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4, is_causal=causal)
    else:
        i = torch.arange(T, device="cuda")[:, None]
        j = torch.arange(Tk, device="cuda")[None, :]
        ok = (j <= i) | (j < prefix) if causal else \
            torch.ones((T, Tk), dtype=torch.bool, device="cuda")
        if window is not None:
            ok = ok & (j > i - window)
        library = lambda: F.scaled_dot_product_attention(     # noqa: E731
            q4, k4, v4, attn_mask=ok)
    if causal and window is None and not prefix and T > 4096:
        plain = lambda: flash_plain_by_rows(q, k, v)          # noqa: E731
    else:
        plain = lambda: flash_ref(                            # noqa: E731
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window,
            prefix_len=prefix).transpose(1, 2)
    return dict(
        shape=f"B={B} T={T}" + (f" Tk={Tk}" if Tk != T else "")
              + f" H={H} K={K} hd={hd} "
              + ("causal" if causal else "non-causal")
              + f" window={window} prefix={prefix}",
        kernel=lambda: flash_mha(q, k, v, causal=causal, window=window,
                                 prefix_len=prefix),
        plain=plain,
        library=library,
        library_label="scaled_dot_product_attention over (B, H, T, hd) "
                      "copies" + (", K/V repeated per head" if G > 1
                                  else ""),
        zero_rows=[],
        **bound_of(work(q, k, v, causal=causal, window=window,
                        prefix_len=prefix)))


def flash_offset_case(gen, dtype, q0: int, window: Optional[int],
                      shared: Dict) -> Dict:
    """A sharded ring prefill's chunk (``layers._zigzag_prefill``): the
    queries [q0, q0 + FLASH_OFFSET_CHUNK) of FLASH_OFFSET_ROWS rows of
    FLASH_OFFSET_KEYS tokens at Phi-3-medium-14B's heads, over the keys up
    to the chunk's last query, through ``flash_mha(q_offset=q0)``.
    ``whole`` gives the same rows of one call over all the queries;
    ``shared`` keeps the inputs and that call per (dtype, window)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.flash_attention.ops import flash_mha, work
    from repro_torch.kernels.flash_attention.ref import flash_ref
    phi = get_config("phi3_medium_14b")
    K, hd = phi.num_kv_heads, phi.head_dim_
    H, B, T, m = phi.num_heads, FLASH_OFFSET_ROWS, FLASH_OFFSET_KEYS, \
        FLASH_OFFSET_CHUNK
    G = H // K
    key = (dtype, window)
    if key not in shared:
        shared.clear()                      # one (dtype, window) at a time
        q = _randn(gen, B, T, H, hd, dtype=dtype)
        k = _randn(gen, B, T, K, hd, dtype=dtype)
        v = _randn(gen, B, T, K, hd, dtype=dtype)
        shared[key] = (q, k, v, flash_mha(q, k, v, window=window))
    q, k, v, whole = shared[key]
    end = q0 + m
    lib = cuda_lib.library()
    code = cuda_lib.DTYPE_CODES[dtype]
    tile = lib.flash_tile_rows(hd, G, m, end, window or 0, code)
    whole_tile = lib.flash_tile_rows(hd, G, T, T, window or 0, code)
    qc = q[:, q0:end].contiguous()
    kc, vc = k[:, :end].contiguous(), v[:, :end].contiguous()
    q4 = qc.transpose(1, 2).contiguous()
    k4 = kc.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    v4 = vc.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    i = torch.arange(q0, end, device="cuda")[:, None]
    j = torch.arange(end, device="cuda")[None, :]
    ok = j <= i
    if window is not None:
        ok = ok & (j > i - window)
    return dict(
        shape=f"B={B} q_offset={q0} Tq={m} Tk={end} H={H} K={K} hd={hd} "
              f"causal window={window} prefix=0",
        kernel=lambda: flash_mha(qc, kc, vc, window=window, q_offset=q0),
        plain=lambda: flash_ref(                              # noqa: E731
            qc.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            window=window, q_offset=q0).transpose(1, 2),
        library=lambda: F.scaled_dot_product_attention(       # noqa: E731
            q4, k4, v4, attn_mask=ok),
        library_label="scaled_dot_product_attention over (B, H, T, hd) "
                      "copies, K/V repeated per head, a mask",
        zero_rows=[], q_offset=q0, whole=whole[:, q0:end], tile_rows=tile,
        # the chunk's tiles (tile / G queries each, the library's rule) and
        # its stages line up with the whole call's: the same sums, bit for
        # bit
        aligned=tile == whole_tile and q0 % (tile // G) == 0,
        **bound_of(work(qc, kc, vc, window=window, q_offset=q0)))


def ring_decode_case(gen, dtype, B: int, S: int, K: int, G: int, pos: int,
                     window: Optional[int] = None, hd: int = 128,
                     sdpa_mask: bool = True, poison: bool = False) -> Dict:
    """Ring-engine decode: one token per row over a ring of S slots that
    has seen positions 0..pos (slot = position % S; wrapped when pos >=
    S), at Llama-2-7B head widths by default.  Without ``sdpa_mask`` the
    library yardstick takes no mask (every slot valid: a cross cache).
    With ``poison`` every masked slot's K holds NaN and its V Inf for the
    kernel, zeros for the plain version and the yardstick."""
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref
    H = K * G
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
    kk, vk = k, v                        # what the kernel reads
    if poison:
        k[:, ~ok] = 0
        v[:, ~ok] = 0
        kk, vk = k.clone(), v.clone()
        kk[:, ~ok] = float("nan")
        vk[:, ~ok] = float("inf")
    # library yardstick: SDPA over K/V already in (B, H, S, hd) and a
    # boolean slot mask (the transposes are not timed)
    q4 = q[:, :, None, :].contiguous()
    k4 = k.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    v4 = v.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
    mask = ok[None, None, None, :].contiguous()
    return dict(
        shape=f"B={B} S={S} K={K} G={G} hd={hd} pos={pos} window={window} "
              f"valid_slots={valid}" + (" masked=NaN/Inf" if poison else ""),
        kernel=lambda: ops.decode_gqa(q, kk, vk, slot_pos, pos,
                                      window=window),
        plain=lambda: decode_attention_ref(q, k, v, slot_pos, pos,
                                           window=window),
        library=lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=mask if sdpa_mask else None),
        library_label="scaled_dot_product_attention over K/V already "
                      "transposed to (B, H, S, hd)"
                      + ("" if sdpa_mask else ", no mask"),
        zero_rows=[],
        **bound_of(ops.work(q, k, v, slot_pos, pos, window=window)))


def phase3_makers(gen) -> Tuple[List, int, Dict]:
    """Phase 3's cases, in order: (kernel name, dtype, maker) with maker()
    -> a case dict (``sgmv_case``, ``decode_case``, ...).  Every bf16 case
    is timed, and every case from index ``timed`` on in float32 too; the
    dict that is returned third is the offset cases' shared state (the
    whole call each chunk is held to), cleared after the phase."""
    Bl, T, S = LAUNCH_BATCH, LAUNCH["prompt_len"], LAUNCH_CONTEXT
    last = T + LAUNCH["max_new"] - 2        # position of the last decode
    makers = []
    for dtype in (torch.bfloat16, torch.float32):
        makers += [
            ("sgmv", dtype,
             lambda d=dtype: sgmv_case(gen, d, SERVE["num_slots"])),
            # the warm-function decode step's rows: one adapter, its
            # batch of LAUNCH_BATCH (the shape phase 5 launches most)
            ("sgmv", dtype, lambda d=dtype: sgmv_case(
                gen, d, LAUNCH_BATCH, run=LAUNCH_BATCH, adapters=1)),
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
        # NaN and Inf in every masked slot's K and V (a stale lap, a fresh
        # cache): the kernel copies masked slots whole and must select
        # them away; the plain version reads the same slots as zeros
        ("decode_attention", bf,
         lambda: ring_decode_case(gen, bf, Bl, S, 8, 4, T + 40,
                                  window=300, poison=True)),
        ("paged_prefill", bf, lambda: prefill_case(gen, bf, K=8, G=4)),
        ("paged_prefill", bf, lambda: prefill_case(gen, bf, window=128)),
        ("paged_prefill", bf, lambda: prefill_case(
            gen, bf, serve=SMALL_BLOCK_SERVE[4])),
        ("paged_prefill", bf, lambda: prefill_case(
            gen, bf, K=8, G=4, serve=SMALL_BLOCK_SERVE[12])),
        ("paged_attention", bf, lambda: decode_case(gen, bf, K=8, G=4)),
        ("paged_attention", bf, lambda: decode_case(gen, bf, window=128)),
        # block sizes 4 and 12 (boxes of 4 rows), 6 (of 2 rows) and 8
        # (phase 18a's)
        *[("paged_attention", bf, lambda bs=bs: decode_case(
            gen, bf, K=8 if bs == 12 else 32, G=4 if bs == 12 else 1,
            serve=dict(SMALL_BLOCK_SERVE[bs], num_blocks=1 + SERVE[
                "num_slots"] * SMALL_BLOCK_SERVE[bs]["max_blocks_per_slot"]),
            positions=(SYSTEM_PROMPT, MAX_PROMPT))) for bs in (4, 6, 8, 12)],
        # NaN and Inf in every masked slot of the tables' blocks and in the
        # garbage block: a TMA box copies a block whole, and the kernel
        # must select the masked slots away
        ("paged_attention", bf, lambda: decode_case(
            gen, bf, K=8, G=4, window=300, poison=True)),
        # SGMV at the prefills' row layouts: the runtime's 4 rows x 64
        # tokens of 4 adapters, the launcher's 3 x 500 of one adapter
        ("sgmv", bf, lambda: sgmv_case(
            gen, bf, SERVE["prefill_rows"] * SERVE["prefill_chunk"],
            run=SERVE["prefill_chunk"])),
        ("sgmv", bf, lambda: sgmv_case(
            gen, bf, LAUNCH_BATCH * LAUNCH["prompt_len"],
            run=LAUNCH["prompt_len"], adapters=1))]
    # phase 8's shapes: Mixtral-8x22B's 48 query heads over 8 kv heads
    # (G = 6), its 4096-key window over ~4600 keys (decode tables with
    # window-reclaimed -1 entries in front), and its LoRA sites at d_model
    # 6144 (q and o: O = 6144; k and v: O = 1024)
    from repro_torch.configs import get_config
    w, mx = get_config(MIXTRAL).sliding_window, MIXTRAL_SERVE
    lo, hi = MIXTRAL_PROMPT
    rows = mx["prefill_rows"] * mx["prefill_chunk"]
    makers += [
        ("paged_attention", bf, lambda: decode_case(
            gen, bf, K=8, G=6, window=w, serve=mx,
            positions=(lo, hi + MIXTRAL_OUTPUT), reclaimed=True)),
        ("paged_prefill", bf, lambda: prefill_case(
            gen, bf, K=8, G=6, window=w, serve=mx,
            starts=(w, hi - mx["prefill_chunk"]))),
        ("sgmv", bf, lambda: sgmv_case(gen, bf, mx["num_slots"], D=6144,
                                       O=6144)),
        ("sgmv", bf, lambda: sgmv_case(gen, bf, rows,
                                       run=mx["prefill_chunk"], D=6144,
                                       O=6144)),
        ("sgmv", bf, lambda: sgmv_case(gen, bf, rows,
                                       run=mx["prefill_chunk"], D=6144,
                                       O=1024))]
    # phases 9 and 10's shapes: RecurrentGemma-9B's 16 query heads over 1
    # kv head of 256 (G = 16) under its 2048-key window over ~2300
    # positions, and Mamba2-780M's LoRA sites (in: 1536 -> 6448, out:
    # 3072 -> 1536), in both dtypes, every case timed
    # (names of their own: the Mixtral cases above read w, lo and hi when
    # they run)
    rg, rgs, mb = get_config(RGEMMA), RGEMMA_SERVE, get_config(MAMBA)
    fused = 2 * mb.d_inner + 2 * mb.ssm_state_dim + mb.ssm_num_heads
    rw, G16 = rg.sliding_window, rg.num_heads // rg.num_kv_heads
    rlo, rhi = RGEMMA_PROMPT
    timed = len(makers)
    for dtype in (torch.bfloat16, torch.float32):
        makers += [
            ("paged_attention", dtype, lambda d=dtype: decode_case(
                gen, d, K=rg.num_kv_heads, G=G16, hd=rg.head_dim_,
                window=rw, serve=rgs, positions=(rlo, rhi + RGEMMA_OUTPUT),
                reclaimed=True)),
            ("paged_prefill", dtype, lambda d=dtype: prefill_case(
                gen, d, K=rg.num_kv_heads, G=G16, hd=rg.head_dim_,
                window=rw, serve=rgs,
                starts=(rw, rhi - rgs["prefill_chunk"]), parts=4))]
        for D, O in ((mb.d_model, fused), (mb.d_inner, mb.d_model)):
            makers += [
                ("sgmv", dtype, lambda d=dtype, D=D, O=O: sgmv_case(
                    gen, d, MAMBA_SERVE["num_slots"], D=D, O=O)),
                ("sgmv", dtype, lambda d=dtype, D=D, O=O: sgmv_case(
                    gen, d, MAMBA_SERVE["prefill_rows"]
                    * MAMBA_SERVE["prefill_chunk"],
                    run=MAMBA_SERVE["prefill_chunk"], D=D, O=O))]
    # phases 11-13 and the ring runs of 9 and 10: Nemotron-4-340B's 96
    # query heads over 8 kv heads of 192 (G = 12) in both paged kernels (8
    # rows at ~2000-2030 keys, 4 x 64 queries at ~1900-2000) and its LoRA
    # sites (q and o: 18432 -> 18432; k and v: 18432 -> 1536); flash at
    # Nemotron's heads, at PaliGemma-3B's (hd 256, G = 8) behind its
    # 256-token image prefix over 512 keys, and at RecurrentGemma-9B's
    # (hd 256, G = 16) over 2112 tokens under its 2048-key window; ring
    # decode at the same three head shapes (PaliGemma's and Nemotron's
    # 552-slot rings, RecurrentGemma's 2048-slot ring wrapped)
    nm, nms = get_config(NEMOTRON), NEMOTRON_SERVE
    nK, nG, nhd = nm.num_kv_heads, nm.num_heads // nm.num_kv_heads, \
        nm.head_dim_
    nhi, pali = NEMOTRON_PROMPT[1], get_config(PALIGEMMA)
    pG = pali.num_heads // pali.num_kv_heads
    ring = pali.num_image_tokens + PALI_TEXT + PALI_NEW + 8
    ppos = pali.num_image_tokens + PALI_TEXT + PALI_NEW - 2
    rT = RGEMMA_RING_PROMPT
    nrows = nms["prefill_rows"] * nms["prefill_chunk"]
    for dtype in (torch.bfloat16, torch.float32):
        makers += [
            ("paged_attention", dtype, lambda d=dtype: decode_case(
                gen, d, K=nK, G=nG, hd=nhd, serve=nms,
                positions=(nhi, nhi + NEMOTRON_OUTPUT))),
            ("paged_prefill", dtype, lambda d=dtype: prefill_case(
                gen, d, K=nK, G=nG, hd=nhd, serve=nms,
                starts=(nhi - 2 * nms["prefill_chunk"],
                        nhi - nms["prefill_chunk"]))),
            ("flash_attention", dtype, lambda d=dtype: flash_case(
                gen, d, RING_ROWS, 512, nK, nG, hd=nhd)),
            ("flash_attention", dtype, lambda d=dtype: flash_case(
                gen, d, PALI_ROWS, pali.num_image_tokens + PALI_TEXT,
                pali.num_kv_heads, pG, hd=pali.head_dim_,
                prefix=pali.num_image_tokens)),
            ("flash_attention", dtype, lambda d=dtype: flash_case(
                gen, d, RING_ROWS, rT, rg.num_kv_heads, G16,
                hd=rg.head_dim_, window=rw)),
            ("decode_attention", dtype, lambda d=dtype: ring_decode_case(
                gen, d, RING_ROWS, ring, nK, nG, ppos, hd=nhd)),
            ("decode_attention", dtype, lambda d=dtype: ring_decode_case(
                gen, d, PALI_ROWS, ring, pali.num_kv_heads, pG, ppos,
                hd=pali.head_dim_)),
            ("decode_attention", dtype, lambda d=dtype: ring_decode_case(
                gen, d, RING_ROWS, rw, rg.num_kv_heads, G16,
                rT + RING_NEW - 2, window=rw, hd=rg.head_dim_))]
        for O in (nm.d_model, nK * nhd):
            makers += [
                ("sgmv", dtype, lambda d=dtype, O=O: sgmv_case(
                    gen, d, nms["num_slots"], D=nm.d_model, O=O)),
                ("sgmv", dtype, lambda d=dtype, O=O: sgmv_case(
                    gen, d, nrows, run=nms["prefill_chunk"], D=nm.d_model,
                    O=O))]
    # phase 13's launcher shapes (its largest batch of 256-token prompts,
    # 280-slot rings): flash and ring decode at SmolLM-360M's 15 query
    # heads over 5 kv heads of 64 (G = 3: ring decode's group of 4 with a
    # masked fourth head) and Qwen2.5-3B's 16 over 2 of 128 (G = 8); SGMV
    # at every LoRA site of phases 12 and 13 (q: D -> H hd, k and v: D ->
    # K hd, o: H hd -> D) at 8 decode rows and the launcher's prefill rows
    # of one adapter, plus the runtime's 4 x 64 rows at PaliGemma-3B's;
    # then flash behind prefixes that end inside a 64-row tile: 77 of 300
    # keys at PaliGemma's heads, and 100 of 150 under a 40-key window
    zS, zpos = ZOO_PROMPT + ZOO_NEW + 8, ZOO_PROMPT + ZOO_NEW - 2
    zoo_heads = [(c.num_kv_heads, c.num_heads // c.num_kv_heads, c.head_dim_)
                 for c in map(get_config, ("smollm_360m", "qwen2_5_3b"))]
    sites = {}
    for arch in ZOO_LAUNCH + (PALIGEMMA,):
        c = get_config(arch)
        qw, kvw = c.num_heads * c.head_dim_, c.num_kv_heads * c.head_dim_
        for D, O in ((c.d_model, qw), (c.d_model, kvw), (qw, c.d_model)):
            sites[D, O] = sites.get((D, O), False) or arch == PALIGEMMA
    for dtype in (torch.bfloat16, torch.float32):
        for zK, zG, zhd in zoo_heads:
            makers += [
                ("flash_attention", dtype,
                 lambda d=dtype, K=zK, G=zG, hd=zhd: flash_case(
                     gen, d, ZOO_ROWS, ZOO_PROMPT, K, G, hd=hd)),
                ("decode_attention", dtype,
                 lambda d=dtype, K=zK, G=zG, hd=zhd: ring_decode_case(
                     gen, d, ZOO_ROWS, zS, K, G, zpos, hd=hd))]
        for (D, O), paged in sorted(sites.items()):
            makers += [
                ("sgmv", dtype, lambda d=dtype, D=D, O=O: sgmv_case(
                    gen, d, ZOO_ROWS, D=D, O=O)),
                ("sgmv", dtype, lambda d=dtype, D=D, O=O: sgmv_case(
                    gen, d, ZOO_ROWS * ZOO_PROMPT, run=ZOO_PROMPT,
                    adapters=1, D=D, O=O))]
            if paged:
                makers.append(
                    ("sgmv", dtype, lambda d=dtype, D=D, O=O: sgmv_case(
                        gen, d, PALI_SERVE["prefill_rows"]
                        * PALI_SERVE["prefill_chunk"],
                        run=PALI_SERVE["prefill_chunk"], D=D, O=O)))
        makers += [
            ("flash_attention", dtype, lambda d=dtype: flash_case(
                gen, d, 2, 300, pali.num_kv_heads, pG, hd=pali.head_dim_,
                prefix=77)),
            ("flash_attention", dtype, lambda d=dtype: flash_case(
                gen, d, 2, 150, 2, 4, window=40, prefix=100))]
    # phase 15's shapes: Whisper-medium's 16 heads of 64 (G = 1) over its
    # 1500 encoder frames, not a whole number of 64-key tiles or 64-slot
    # partitions: the encoder's non-causal self-attention (1500 x 1500),
    # cross-attention prefill (the 32-token prompts over 1500 keys) and
    # cross-attention decode (one query a row over 1500 static slots, all
    # visible: slot positions [0, 1500), the query at 1499)
    wh = get_config(WHISPER)
    wS, wK, whd = wh.encoder_seq, wh.num_kv_heads, wh.head_dim_
    for dtype in (torch.bfloat16, torch.float32):
        makers += [
            ("flash_attention", dtype, lambda d=dtype: flash_case(
                gen, d, WHISPER_ROWS, wS, wK, 1, hd=whd, causal=False)),
            ("flash_attention", dtype, lambda d=dtype: flash_case(
                gen, d, WHISPER_ROWS, WHISPER_PROMPT, wK, 1, hd=whd,
                Tk=wS, causal=False)),
            ("decode_attention", dtype, lambda d=dtype: ring_decode_case(
                gen, d, WHISPER_ROWS, wS, wK, 1, wS - 1, hd=whd,
                sdpa_mask=False))]
    # phase 17's shapes: Llama-2-7B's sharded steps, flash causal over one
    # row of 32768 tokens (prefill_32k at one row) and ring decode of two
    # rows over 32768 slots (decode_32k at two rows, the ring wrapped)
    makers += [
        ("flash_attention", bf, lambda: flash_case(
            gen, bf, SHARDED_PREFILL_ROWS, SHARDED_CONTEXT, 32, 1)),
        ("decode_attention", bf, lambda: ring_decode_case(
            gen, bf, SHARDED_DECODE_ROWS, SHARDED_CONTEXT, 32, 1,
            SHARDED_CONTEXT + SHARDED_DECODE_STEPS - 1))]
    # a sharded ring prefill's chunks: flash with a query offset
    shared: Dict = {}
    for dtype in (torch.bfloat16, torch.float32):
        makers += [("flash_attention", dtype,
                    lambda d=dtype, q0=q0, w=w: flash_offset_case(
                        gen, d, q0, w, shared)) for q0, w in FLASH_OFFSETS]
    return makers, timed, shared


# the redesigned kernels (one launch each, fixed-order sums; paged decode's
# float32 split-KV kernels sum in a fixed order too): two calls on the
# same inputs must give equal outputs bit for bit
REPEATABLE = ("sgmv", "decode_attention", "paged_attention")


def one_call(name: str, dtype: torch.dtype, fn: Callable[[], object]
             ) -> Dict:
    """The kernels the profiler shows for one call of a decode wrapper and
    the blocks the call allocates: in bf16 one kernel and the output
    alone, in float32 the partitions, their merge and three scratch
    arrays besides (``profiled_kinds``).  A profile that falls short
    while it lost markers (F7) is taken again."""
    want = {k: 1 for k in profiled_kinds(name, dtype)}
    torch.cuda.synchronize()
    key = "allocation.all.allocated"
    before = torch.cuda.memory_stats()[key]
    fn()
    allocs = torch.cuda.memory_stats()[key] - before
    for _ in range(PROFILE_ATTEMPTS):
        prof = profiled(fn)
        got = prof.get("kernels_by_kind") or {}
        if got == want or not prof.get("markers_lost"):
            break
    if got != want:
        fail(f"{name} {dtype}: one call shows kernels {got}, expected "
             f"{want}")
    if allocs != 1 + 3 * (dtype == torch.float32):
        fail(f"{name} {dtype}: one call allocated {allocs} blocks")
    return {"kernels": got, "allocations": allocs}


def kernels_phase() -> Dict[str, Dict]:
    """Every kernel against its plain version; the bf16 cases are timed.
    Returns name -> the numbers of its first timed (main-path) case."""
    t0 = phase("phase 3: kernels vs plain versions on the card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    makers, timed, shared = phase3_makers(gen)
    summary: Dict[str, Dict] = {}
    results: List[Dict] = []
    for i, (name, dtype, make) in enumerate(makers):
        c = make()
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            fail(f"{name} {c['shape']}: kernel gives {tuple(got.shape)} "
                 f"{got.dtype}, plain {tuple(want.shape)} {want.dtype}")
        if not torch.isfinite(got).all():
            fail(f"{name} {c['shape']} {dtype}: non-finite kernel output")
        diff = got.float() - want.float()
        err = float(diff.abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        tol = TOL[dtype] * scale
        # per row: RMS of the difference over RMS of the plain row (an
        # all-zero plain row must come out exact)
        rms = want.float().pow(2).mean(-1).sqrt()
        row_err = float((diff.pow(2).mean(-1).sqrt()
                         / rms.clamp(min=torch.finfo(torch.float32).tiny)
                         ).max())
        for row in c["zero_rows"]:
            if bool(got[row].any()):
                fail(f"{name}: row {row} must be exact zeros")
        if name in REPEATABLE and not torch.equal(got, c["kernel"]()):
            fail(f"{name} {c['shape']} {dtype}: a second call on the same "
                 f"inputs differs")
        calls = (one_call(name, dtype, c["kernel"])
                 if name == "paged_attention" else None)
        row = {"name": name, "dtype": str(dtype).replace("torch.", ""),
               "shape": c["shape"], "max_abs_err": err, "tol": tol,
               "max_row_rel_rms": row_err,
               "bitwise_repeat": name in REPEATABLE, "one_call": calls,
               "bytes": c["bytes"], "ops": c["ops"],
               "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
               "library": c["library_label"]}
        if "whole" in c:
            # the chunk's rows against one call over all the queries
            row["q_offset"] = c["q_offset"]
            row["tile_rows"] = c["tile_rows"]
            row["equal_to_whole"] = bool(torch.equal(got, c["whole"]))
            row["max_abs_diff_to_whole"] = float(
                (got.float() - c["whole"].float()).abs().max())
            if c["aligned"] and not row["equal_to_whole"]:
                fail(f"{name} {c['shape']} {dtype}: an offset aligned with "
                     f"the tiles must give the whole call's rows bit for "
                     f"bit; they differ by "
                     f"{row['max_abs_diff_to_whole']:.3e}")
            if not row["max_abs_diff_to_whole"] <= tol:
                fail(f"{name} {c['shape']} {dtype}: the chunk's rows differ "
                     f"from the whole call's by "
                     f"{row['max_abs_diff_to_whole']:.3e} > {tol:.3e}")
        if dtype == torch.bfloat16 or i >= timed:
            row["ms"] = device_ms(c["kernel"], 50, flush)
            row["plain_ms"] = device_ms(c["plain"], 10, flush)
            row["library_ms"] = (device_ms(c["library"], 50, flush)
                                 if c["library"] is not None else None)
            row["bound_share"] = row["bound_ms"] / row["ms"]
        print(json.dumps(row))
        if not err <= tol:
            fail(f"{name} {c['shape']} {dtype}: max |kernel - plain| = "
                 f"{err:.3e} > {tol:.3e}")
        if not row_err <= TOL[dtype]:
            fail(f"{name} {c['shape']} {dtype}: a row's RMS |kernel - "
                 f"plain| is {row_err:.3e} of its plain RMS > "
                 f"{TOL[dtype]:.3e}")
        results.append(row)
        summary.setdefault(name, row)
        del c, got, want
    shared.clear()
    torch.cuda.empty_cache()
    refused = alignment_cases(gen)
    lse_err = ring_lse_check(gen)
    plans = plan_check()
    print(f"phase 3 ok: {len(results)} cases within tolerance, "
          f"{refused} wrappers refuse a misaligned operand "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"summary": summary, "cases": results,
            "ring_lse_max_abs_err": lse_err, "plans": plans}


# The libraries' grid rules at the main path's shapes: the values that
# tests/test_torch_sgmv_tile_precision.py, test_torch_ring_decode_step.py
# and test_torch_paged_decode_step.py pin of their Python copies.  SGMV
# (R, D, O) -> (cluster, copies over O, columns a tile); ring decode (B, K,
# G, S, hd) -> (cluster, slots a partition); paged decode (B, K, G, MB, bs,
# hd) -> (cluster, slots a stage, stages): phases 4 and 6, 8, 9, 11 and 18a.
SGMV_PLANS = {(3, 4096, 4096): (16, 8, 32), (8, 4096, 4096): (16, 8, 32),
              (256, 4096, 4096): (8, 4, 128),
              (1500, 4096, 4096): (8, 1, 512),
              (2048, 5120, 5120): (4, 1, 256)}
RING_PLANS = {(3, 32, 1, 540, 128): (1, 64),
              (2, 32, 1, 32768, 128): (2, 64),
              (4, 16, 1, 1500, 64): (2, 128),
              (4, 1, 8, 552, 256): (8, 32)}
PAGED_PLANS = {(8, 32, 1, 64, 16, 128): (1, 64, 3),
               (8, 8, 6, 304, 16, 128): (2, 64, 3),
               (8, 1, 16, 168, 16, 256): (8, 64, 3),
               (8, 8, 12, 132, 16, 192): (2, 64, 3),
               (8, 32, 1, 8, 8, 128): (1, 64, 3)}


def plan_check() -> Dict:
    """``sgmv_plan``, ``ring_decode_plan`` and ``paged_decode_plan`` of the
    library against SGMV_PLANS, RING_PLANS and PAGED_PLANS."""
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    got = {}
    for (R, D, O), want in SGMV_PLANS.items():
        v = lib.sgmv_plan(R, D, O)
        got[f"sgmv {R} x {D} -> {O}"] = have = (v & 255, v >> 8 & 255,
                                                v >> 16)
        if have != want:
            fail(f"sgmv_plan({R}, {D}, {O}) = {have}, the tests pin {want}")
    for shape, want in RING_PLANS.items():
        v = lib.ring_decode_plan(*shape)
        got[f"ring decode {shape}"] = have = (v & 255, v >> 8 & 255)
        if have != want:
            fail(f"ring_decode_plan{shape} = {have}, the tests pin {want}")
    for shape, want in PAGED_PLANS.items():
        v = lib.paged_decode_plan(*shape)
        got[f"paged decode {shape}"] = have = (v & 255, v >> 8 & 255,
                                               v >> 16)
        if have != want:
            fail(f"paged_decode_plan{shape} = {have}, the tests pin {want}")
    print(f"grid rules as the tests pin them: {got}")
    return got


def ring_lse_check(gen) -> float:
    """``decode_gqa(return_lse=True)``, which the merge across ranks that
    split a ring's slots reads (``models/layers.py::_merge_partials``):
    its output equal to the plain call's bit for bit, its log-sum-exp
    within RING_LSE_TOL of the plain version's, in bf16 and float32 at
    Llama-2-7B's heads over a wrapped ring and at Nemotron's G = 12 /
    hd 192.  Returns the largest error."""
    from repro_torch.kernels.decode_attention.ops import decode_gqa
    from repro_torch.kernels.decode_attention.ref import \
        decode_attention_ref
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for B, S, K, G, hd, pos in ((8, 540, 32, 1, 128, 700),
                                    (4, 543, 8, 12, 192, 542)):
            q = _randn(gen, B, K * G, hd, dtype=dtype)
            k = _randn(gen, B, S, K, hd, dtype=dtype)
            v = _randn(gen, B, S, K, hd, dtype=dtype)
            p = torch.arange(max(0, pos - S + 1), pos + 1, device="cuda",
                             dtype=torch.int32)
            slot_pos = torch.full((S,), -1, dtype=torch.int32,
                                  device="cuda")
            slot_pos[(p % S).long()] = p
            out, lse = decode_gqa(q, k, v, slot_pos, pos, return_lse=True)
            if not torch.equal(out, decode_gqa(q, k, v, slot_pos, pos)):
                fail(f"ring decode {dtype} G={G}: return_lse changes the "
                     f"output")
            _, want = decode_attention_ref(q, k, v, slot_pos, pos,
                                           return_lse=True)
            err = float((lse - want).abs().max())
            worst = max(worst, err)
            if not err <= RING_LSE_TOL:
                fail(f"ring decode {dtype} G={G}: lse max |err| {err:.3e} "
                     f"> {RING_LSE_TOL}")
    print(f"ring decode lse (the merge across ranks that split a ring's "
          f"slots): output equal to the plain call's, lse max |err| "
          f"{worst:.3e} <= {RING_LSE_TOL} (bf16 and float32, G 1 and 12)")
    return worst


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


def system_prompt_trace(vocab: int, n: int, prompt, output: int, seed: int,
                system: int = SYSTEM_PROMPT):
    """``n`` greedy requests round robin over the ADAPTERS functions, each
    function with its own ``system``-token system prompt, prompts of
    ``prompt`` tokens, ``output`` output tokens, arrivals 20 ms apart."""
    rng = np.random.default_rng(seed)
    sys_prompt = {f: rng.integers(0, vocab, system).astype(np.int32)
                  for f in range(ADAPTERS)}
    work, prompts = [], {}
    for rid in range(n):
        f = rid % ADAPTERS
        L = int(rng.integers(prompt[0], prompt[1] + 1))
        prompts[rid] = np.concatenate([
            sys_prompt[f],
            rng.integers(0, vocab, L - system).astype(np.int32)])
        work.append(dict(req_id=rid, fn_id=f"fn{f}", arrival=0.02 * rid,
                         prompt_len=L, output_len=output, slo_ttft=1e9))
    return work, prompts


def expected_launches(cfg, prefills: int, steps: int) -> Dict[str, int]:
    """Launches of ``prefills`` prefill dispatches and ``steps`` decode
    steps: one paged kernel per ATTN layer, one SGMV per LoRA site (q/k/v/o
    of an ATTN layer, in/out of a REC or SSD block)."""
    attn = cfg.layer_kinds.count("attn")
    sites = sum(len(set(cfg.lora.targets) & ({"q", "k", "v", "o"}
                                             if kind == "attn"
                                             else {"in", "out"}))
                for kind in cfg.layer_kinds)
    return {"sgmv": sites * (prefills + steps),
            "paged_attention": attn * steps,
            "paged_prefill": attn * prefills,
            "flash_attention": 0, "decode_attention": 0}


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
    values: it is ANDed in place into one persistent device flag, so a
    CUDA graph captured in the block checks every replay too (the flag
    lives as long as this object; keep it alive while such graphs
    replay)."""

    def __enter__(self):
        from repro_torch.models import transformer as tf
        self.tf, self.plain, self.calls = tf, tf._logits, 0
        self.flag = torch.ones((), dtype=torch.bool, device="cuda")

        def checked(p, c, x):
            out = self.plain(p, c, x)
            self.flag.logical_and_(torch.isfinite(out).all())
            self.calls += 1
            return out

        tf._logits = checked
        return self

    def __exit__(self, *exc):
        self.tf._logits = self.plain

    def ok(self) -> bool:
        return self.calls > 0 and bool(self.flag)


class EagerDispatch:
    """A runtime dispatch driven through ``GraphedDispatch.eager``: the
    same function, uncaptured (the graphs' comparison)."""

    def __init__(self, dispatch):
        self.dispatch = dispatch

    def __call__(self, *args):
        return self.dispatch.eager(*args)

    def _cache_size(self) -> int:
        return 0


def _smi(device: Dict) -> str:
    return f"{device['kind']} [{'; '.join(device['nvidia_smi'])}]"


def bank_ptrs(params) -> List[int]:
    from repro_torch.core.lora import partition_lora, tree_leaves
    return [t.data_ptr() for t in tree_leaves(partition_lora(params)[1])]


def churn_adapter(cfg, params, seed: int):
    """A single-adapter tree for the registry (the bank's structure, one
    adapter's (D, r) / (r, O) leaves), random from ``seed`` at the init
    scales of ``init_params``: A ~ N(0, 1/D), B ~ N(0, 0.02)."""
    from repro_torch.core.lora import partition_lora, take_adapter
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def draw(x):
        rows, cols = x.shape
        scale = 1 / math.sqrt(rows) if cols == cfg.lora.rank else 0.02
        return _randn(gen, rows, cols, dtype=x.dtype, scale=scale)

    return _tree_map(draw, take_adapter(partition_lora(params)[1], 0))


def serve_phase(cfg, params, device: Dict) -> Dict:
    from repro_torch import kernels
    from repro_torch.core.lora import (combine_lora, partition_lora,
                                       take_adapter)
    from repro_torch.serving import (AdapterRegistry, CompileGuard,
                                     ContinuousRuntime, GraphedDispatch,
                                     ServingConfig, replay_trace,
                                     terminal_state)

    t0 = phase("phase 4: serve Llama-2-7B on the card")
    layers = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    scfg = ServingConfig(**SERVE)
    rt = ContinuousRuntime(cfg, params, scfg)
    names = [f"fn{i}" for i in range(ADAPTERS)]
    reg = AdapterRegistry(rt, names=names)
    ptrs = bank_ptrs(params)
    print(f"serving: {SERVE}; registry {reg.names()} over a bank of "
          f"{rt.bank_slots}")
    work, prompts, slots = shared_prefix_trace(
        REQUESTS, ADAPTERS, SYSTEM_PROMPT, MAX_PROMPT, OUTPUT_TOKENS,
        cfg.vocab_size, seed=0)
    fn_adapter = {fn: fn for fn in slots}           # fn_id -> registry name
    print(f"trace: {len(work)} greedy requests, {ADAPTERS} adapters, "
          f"prompts {min(w['prompt_len'] for w in work)}-"
          f"{max(w['prompt_len'] for w in work)} tokens "
          f"({SYSTEM_PROMPT}-token system prompt per adapter), "
          f"{OUTPUT_TOKENS} output tokens")

    sink: Dict[int, List[int]] = {}
    churn_sink: Dict[int, List[int]] = {}
    with FiniteLogits() as finite, CompileGuard(
            {"decode": 1, "prefill": 1}, runtime=rt) as guard:
        kernels.reset_launches()
        t_run = time.perf_counter()
        res, _ = replay_trace(rt, work, fn_adapter, prompts=prompts,
                              prefill_group=SERVE["prefill_rows"],
                              token_sink=sink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = kernels.launch_counts()
        dispatched = (rt.stats["prefill_chunks"], rt.stats["decode_chunks"])
        peak = torch.cuda.max_memory_allocated() / 1e9
        reserved = torch.cuda.max_memory_reserved() / 1e9
        round1 = rt.check_invariants(res.requests)
        # adapter churn while serving goes on: fn3 out, fn3b into its slot
        saved = _map_clone(take_adapter(partition_lora(params)[1],
                                        reg.slot_of("fn3")))
        reg.unload("fn3")
        slot3 = reg.load("fn3b", churn_adapter(cfg, params, seed=1))
        churn_work, churn_prompts = churn_trace(cfg, REQUESTS)
        churn_res, _ = replay_trace(
            rt, churn_work, {"fn3b": "fn3b", "fn0": "fn0"},
            prompts=churn_prompts, prefill_group=SERVE["prefill_rows"],
            token_sink=churn_sink)
        torch.cuda.synchronize()
    report = guard.report()
    print(f"CompileGuard: {json.dumps(report)}")
    if report["decode_compiles"] != 1 or report["prefill_compiles"] != 1:
        fail(f"dispatches captured more than once: {report}")

    for r in res.requests:
        print(f"req {r.req_id:2d} {r.fn_id} prompt "
              f"{r.prompt_len:3d}: {terminal_state(r)}, "
              f"{len(sink.get(r.req_id, []))} tokens, ttft "
              f"{r.first_token - r.arrival:.4f} s, done at {r.done:.4f} s")
    states = [terminal_state(r) for r in res.requests + churn_res.requests]
    if states != ["finished"] * len(states):
        fail(f"not every request finished: {states}")
    if any(len(sink[w["req_id"]]) != OUTPUT_TOKENS for w in work):
        fail("a request emitted the wrong number of tokens")
    if round1["pool"]["live"] != 0 or round1["slots_active"] != 0:
        fail(f"blocks or slots still held after the drain: {round1}")
    if not finite.ok():
        fail("non-finite logits during the replays")
    for layer in rt.cache:
        for pool in layer.values():
            if not bool(torch.isfinite(pool).all()):
                fail("non-finite entries in a KV pool")

    # each capture runs its dispatch eagerly once before it (graphs.py)
    prefills = dispatched[0] + 2 + 1             # + warmup's two, capture's
    steps = (dispatched[1] + 2 + 1) * scfg.decode_chunk
    sites = len(cfg.lora.targets)
    expected = expected_launches(cfg, prefills, steps)
    print(f"launches {launches}, expected {expected} ({prefills} prefill "
          f"dispatches, {steps} decode steps incl. warmup and the eager run "
          f"before each capture, {layers} layers, {sites} LoRA sites)")
    if launches != expected:
        fail("launch counts differ from layers x dispatches x sites")

    # the churned adapter against a bank that held fn3b from the start
    if bank_ptrs(params) != ptrs:
        fail("a LoRA bank leaf moved during the adapter churn")
    backbone, bank = partition_lora(params)
    rt2 = ContinuousRuntime(cfg, combine_lora(backbone, _map_clone(bank)),
                            scfg)
    oracle_sink: Dict[int, List[int]] = {}
    replay_trace(rt2, churn_work, {"fn3b": slot3, "fn0": 0},
                 prompts=churn_prompts, prefill_group=SERVE["prefill_rows"],
                 token_sink=oracle_sink)
    del rt2
    if churn_sink != oracle_sink:
        fail(f"churned adapter's tokens differ from a fresh bank's: "
             f"{[k for k in churn_sink if churn_sink[k] != oracle_sink.get(k)]}")
    print(f"churn: fn3 unloaded, fn3b loaded into slot {slot3}; "
          f"{len(churn_sink)} requests ({sum(map(len, churn_sink.values()))}"
          f" tokens) equal to a runtime whose bank held fn3b from the "
          f"start; {len(ptrs)} LoRA leaves kept their data_ptr; counters "
          f"loads {rt.stats['adapter_loads']} unloads "
          f"{rt.stats['adapter_unloads']}")
    reg.unload("fn3b")
    if reg.load("fn3", saved) != slot3 or bank_ptrs(params) != ptrs:
        fail("restoring fn3 moved it or the bank")

    eager = eager_compare(cfg, params, scfg, names, work, prompts,
                          fn_adapter, sink)

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
        "peak_memory_gb": peak, "peak_reserved_gb": reserved,
        "launches": launches, "compile_guard": report,
        "captures_process_wide": GraphedDispatch.captures,
        "churn_requests": len(churn_sink), "eager": eager,
        "launches_per_prefill_dispatch": {
            "sgmv": sites * layers, "paged_prefill": layers},
        "launches_per_decode_step": {
            "sgmv": sites * layers, "paged_attention": layers},
    }
    print(f"TTFT p50 {out['ttft_p50_s']:.4f} s, TPOT p50 "
          f"{out['tpot_p50_s']:.4f} s, {out['tokens_per_s']:.1f} tokens/s "
          f"(replay clock), replay wall {wall:.1f} s, peak memory "
          f"{peak:.2f} GB allocated, {reserved:.2f} GB reserved (graphs "
          f"captured) on {_smi(device)}; shared block maps "
          f"{out['shared_block_maps']}")
    out["breakdown"] = breakdown(rt, cfg, device)
    if not finite.ok():
        fail("non-finite logits during the breakdown's replays")
    # the runtime, its registry and its dispatches refer to each other (and
    # the guard to them): collect the cycle, so that phase 5's peak memory
    # does not hold this runtime's pools
    del rt, reg, guard
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 4 ok ({time.perf_counter() - t0:.1f} s)")
    return out


def _tree_map(fn, tree):
    """``fn`` on every tensor leaf of a nested dict/list; None stays."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def _map_clone(tree):
    return _tree_map(torch.Tensor.clone, tree)


def churn_trace(cfg, first_id: int):
    """Four requests on fn3b and two on fn0 (fn0's shared system prompt
    differs from the first round's: new prompts from seed 5)."""
    rng = np.random.default_rng(5)
    work, prompts = [], {}
    for i, fn in enumerate(["fn3b"] * 4 + ["fn0"] * 2):
        rid = first_id + i
        prompts[rid] = rng.integers(0, cfg.vocab_size, int(rng.integers(
            SYSTEM_PROMPT, MAX_PROMPT // 2))).astype(np.int32)
        work.append(dict(req_id=rid, fn_id=fn, arrival=0.02 * i,
                         prompt_len=len(prompts[rid]),
                         output_len=OUTPUT_TOKENS, slo_ttft=1e9))
    return work, prompts


def eager_compare(cfg, params, scfg, names, work, prompts, fn_adapter,
                  sink) -> Dict:
    """The first round's trace on a runtime whose two dispatches run
    eagerly: its greedy tokens must equal the captured runtime's.  Then a
    decode step's logits, as one captured graph and eagerly, on the same
    inputs over this runtime's pools: within TOL[bf16] x max(1, max
    |eager|), since both run the same kernels on the same inputs."""
    from repro_torch.serving import (AdapterRegistry, ContinuousRuntime,
                                     GraphedDispatch, replay_trace)
    rt = ContinuousRuntime(cfg, params, scfg)
    AdapterRegistry(rt, names=names)
    rt._decode = EagerDispatch(rt._decode)
    rt._prefill = EagerDispatch(rt._prefill)
    eager_sink: Dict[int, List[int]] = {}
    replay_trace(rt, work, fn_adapter, prompts=prompts,
                 prefill_group=SERVE["prefill_rows"], token_sink=eager_sink)
    if eager_sink != sink:
        fail(f"eager and captured runtimes emit different tokens for "
             f"{[k for k in sink if sink[k] != eager_sink.get(k)]}")

    def step(tok, pos, tbl, ai):
        return rt._serve(rt.params, tok, rt.cache, pos, adapter_idx=ai,
                         block_tbl=tbl)[0]

    rng = np.random.default_rng(3)
    B, MB = scfg.num_slots, scfg.max_blocks_per_slot
    pos = rng.integers(SYSTEM_PROMPT, MAX_PROMPT, B).astype(np.int32)
    tbl = (rng.permutation(scfg.num_blocks - 1)[:B * MB] + 1).reshape(
        B, MB).astype(np.int32)
    args = (rng.integers(0, cfg.vocab_size, B).astype(np.int32), pos, tbl,
            (np.arange(B) % ADAPTERS).astype(np.int32))
    probe = GraphedDispatch(step, "cuda")
    got = probe(*args)
    want = probe.eager(*args)
    err = float((got.float() - want.float()).abs().max())
    tol = TOL[torch.bfloat16] * max(1.0, float(want.float().abs().max()))
    print(f"eager runtime: {len(eager_sink)} requests, tokens equal to the "
          f"captured runtime's; decode-step logits captured vs eager: max "
          f"|diff| {err:.3e} (tol {tol:.3e})")
    if not err <= tol:
        fail(f"captured and eager logits differ by {err:.3e} > {tol:.3e}")
    del rt, probe
    gc.collect()
    torch.cuda.empty_cache()
    return {"requests": len(eager_sink), "logits_max_abs_err": err,
            "logits_tol": tol}


def _kernel_kind(name: str) -> str:
    low = name.lower()
    for key, kind in (("sgmv_", "sgmv"),
                      ("paged_decode", "paged_attention"),
                      ("paged_prefill", "paged_prefill"),
                      ("flash_kernel", "flash_attention"),
                      ("ring_decode", "decode_attention"),
                      ("split_kv_merge", "decode_merge"),
                      ("prefill_split_merge", "prefill_merge"),
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


def profiled(fn: Callable[[], object],
             by_op: Optional[Callable] = None) -> Dict:
    """Run ``fn`` once under ``torch.profiler``: the union of device
    activity and device time by kind (the profiler's host wall time is
    kept too; it is inflated by the tracing itself), and ``sgmv_union_ms``,
    the union of the SGMV kernel's spans (one kernel a call,
    whose launches do not overlap: its device ms).  ``by_op`` maps the CPU op
    that launched a kernel (a profiler ``FunctionEvent``) to a kind:
    ``device_ms_by_op`` then sums the kernels' device time by it.

    The profiler drops records at a session's ends, in a process that
    has launched no port kernel too (``tools/profiler_record_loss.py``;
    ROADMAP section 3, F7): in some processes that have run phase 3 the
    first 3-4 records of every session, and in 1-2% of sessions up to
    ~460 records at the start, ~90 at the end, or all of them.  So ``fn``
    runs PROFILER_SETTLE_S after the session starts, between two runs of
    MARKERS zero-cycle spin kernels, each synchronised, which take the
    losses at the ends; the markers are left out of every number, and
    ``markers_lost`` counts those the profiler dropped."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def markers() -> None:
        for _ in range(MARKERS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILER_SETTLE_S)
        markers()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        markers()
    spans, sgmv, by_kind, count = [], [], {}, {}
    seen = 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if "spin_kernel" in e.name:
            seen += 1
            continue
        start, end = e.time_range.start, e.time_range.end
        spans.append((start, end))
        kind = _kernel_kind(e.name)
        by_kind[kind] = by_kind.get(kind, 0.0) + (end - start) / 1e3
        count[kind] = count.get(kind, 0) + 1
        if kind.startswith("sgmv"):
            sgmv.append((start, end))
    lost = 2 * MARKERS - seen
    if not spans:
        return {"profiled_wall_ms": host_ms, "device_busy_ms": None,
                "device_ms_by_kind": None, "markers_lost": lost,
                "note": "the profiler saw no device events: not measured"}
    out = {"profiled_wall_ms": host_ms, "device_busy_ms": _union_ms(spans),
           "device_ms_by_kind": dict(sorted(by_kind.items())),
           "kernels_by_kind": dict(sorted(count.items())),
           "sgmv_union_ms": _union_ms(sgmv), "markers_lost": lost}
    if by_op is not None:
        ops: Dict[str, float] = {}
        for e in prof.events():
            if e.device_type != DeviceType.CPU:
                continue
            for k in e.kernels:
                if "spin_kernel" not in k.name:
                    kind = by_op(e)
                    ops[kind] = ops.get(kind, 0.0) + k.duration / 1e3
        out["device_ms_by_op"] = dict(sorted(ops.items()))
    return out


# kernels the profiler shows for one launch of each wrapper in bf16, the
# serving dtype of every profiled round; in float32 the two decode
# wrappers launch their partitions and a merge (FLOAT32_KINDS)
PROFILED_KINDS = {"sgmv": ("sgmv",),
                  "paged_attention": ("paged_attention",),
                  "paged_prefill": ("paged_prefill",),
                  "flash_attention": ("flash_attention",),
                  "decode_attention": ("decode_attention",)}
FLOAT32_KINDS = {"paged_attention": ("paged_attention", "decode_merge"),
                 "decode_attention": ("decode_attention", "decode_merge")}


def profiled_kinds(name: str, dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[str, ...]:
    if dtype == torch.float32:
        return FLOAT32_KINDS.get(name, PROFILED_KINDS[name])
    return PROFILED_KINDS[name]


def cross_check(label: str, launches: Dict[str, int], prof: Dict, *,
                last: bool = True) -> Dict:
    """The wrappers' launch counts over a profiled round (replays included)
    against the kernels the profiler reported by name: each launch must
    show up once under each of its kinds.  A profiler that reports a
    graph's kernels one by one gives equal counts; one that does not
    reports fewer, which is printed and not failed on (then it is the
    profiler, not the port, that cannot see inside the graph).  Counts
    that fall short while the profiler dropped markers are the profiler
    losing records (F7): unless this is the ``last`` attempt, the result
    asks for the round again (``retry``) instead of failing."""
    want: Dict[str, int] = {}
    for name, n in launches.items():
        for kind in profiled_kinds(name):
            want[kind] = want.get(kind, 0) + n
    seen = prof.get("kernels_by_kind") or {}
    got = {k: seen.get(k, 0) for k in want}
    match = got == want
    retry = (not last and not match and bool(prof.get("markers_lost"))
             and all(got[k] <= want[k] for k in want))
    print(f"{label} launch cross-check: wrappers {want}, profiler {got}: "
          + ("equal" if match else "NOT equal") + f" (the profiler dropped "
          f"{prof.get('markers_lost')} of {2 * MARKERS} markers)"
          + ("; profiling the round again" if retry else ""))
    if not match and not retry and all(v > 0 for v in got.values()):
        fail(f"{label}: the profiler sees the kernels but not as many as "
             f"the wrappers launched")
    return {"wrappers": want, "profiler": got, "equal": match,
            "retry": retry}


def checked_rounds(label: str, profile_round: Callable[[], List]
                   ) -> Tuple[List, List[Dict]]:
    """``profile_round()`` profiles one round and returns its parts as
    ``(name, wrapper launches, profiled())``; each part is held to its
    launches by ``cross_check``.  Where the profiler fell short and lost
    markers, the round is profiled again, PROFILE_ATTEMPTS times at most
    in all, each attempt printed; ``profile_round`` must leave the state
    that later checks read as one round does (a fresh round of the same
    shape, or one that repeats from the same state).  Returns the last
    attempt's parts and checks."""
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        parts = profile_round()
        tag = (f" (attempt {attempt} of {PROFILE_ATTEMPTS})"
               if attempt > 1 else "")
        checks = [cross_check(f"{label} {name}{tag}", launches, prof,
                              last=attempt == PROFILE_ATTEMPTS)
                  for name, launches, prof in parts]
        if not any(c["retry"] for c in checks):   # the last never retries
            break
    for c in checks:
        c["attempts"] = attempt
    return parts, checks


def wall_ms(fn: Callable[[], object]) -> float:
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def breakdown(rt, cfg, device: Dict, prompt_len: int = 512) -> Dict:
    """Where the time of the two dispatches goes, at full width.  A round
    admits two groups of ``prefill_rows`` fresh ``prompt_len``-token
    prompts (8 prefill dispatches each at 512 tokens), which fills the
    slots, runs 4 decode chunks with every slot busy, and drains the
    pool.  Two rounds run from the same
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
        return [ServeRequest(prompt=rng.integers(0, cfg.vocab_size,
                                                 prompt_len),
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

    from repro_torch import kernels

    def counted(fn) -> Callable[[], object]:
        def run():
            before = kernels.launch_counts()
            fn()
            after = kernels.launch_counts()
            counts.append({k: after[k] - before[k] for k in after
                           if after[k] > before[k]})
        return run

    drain()
    reqs = fresh()
    pre_wall = wall_ms(lambda: admit(reqs))
    dec_wall = wall_ms(decode4)
    counts: List[Dict[str, int]] = []

    def profile_round() -> List:
        # a fresh round of the same shape from the empty runtime each time
        drain()
        reqs = fresh()
        counts.clear()
        pre = profiled(counted(lambda: admit(reqs)))
        dec = profiled(counted(decode4))
        return [("prefill", counts[0], pre), ("decode", counts[1], dec)]

    parts, checks = checked_rounds("breakdown", profile_round)
    drain()
    pre, dec = parts[0][2], parts[1][2]
    per_group = -(-prompt_len // scfg.prefill_chunk)
    steps = 4 * scfg.decode_chunk
    res = {"prefill_admission": {"dispatches": 2 * per_group,
                                 "wall_ms": pre_wall, **pre},
           "decode_4_chunks": {"steps": steps, "wall_ms": dec_wall, **dec}}
    report_rounds("breakdown", res)
    res["prefill_admission"]["cross_check"] = checks[0]
    res["decode_4_chunks"]["cross_check"] = checks[1]
    per_step(f"decode step, {scfg.num_slots} rows (captured chunks of "
             f"{scfg.decode_chunk})", dec_wall, dec, steps, device)
    per_step(f"prefill dispatch, {g} rows x {scfg.prefill_chunk} tokens "
             f"(captured)", pre_wall, pre, 2 * per_group, device)
    return res


def per_step(label: str, wall: float, prof: Dict, n: int,
             device: Dict) -> None:
    busy = prof["device_busy_ms"]
    print(f"{label}: host wall {wall / n:.2f} ms against device busy "
          + (f"{busy / n:.2f} ms, idle share {1 - busy / wall:.3f}"
             if busy is not None else "not measured")
          + f" on {_smi(device)}")


def report_rounds(label: str, res: Dict[str, Dict]) -> Dict[str, Dict]:
    """Add each round's profiler slowdown and idle share (1 - device busy /
    unprofiled host wall), print it, and fail when the device was busy
    longer than the host wall of the same work: the profiled round's.  A
    round that keeps the device saturated (idle share about 0) may show a
    slightly negative idle share against the unprofiled round's wall: the
    profiler's per-kernel overhead lengthens the busy time it measures."""
    for name, r in res.items():
        r["profiler_slowdown"] = r["profiled_wall_ms"] / r["wall_ms"]
        if r["device_busy_ms"] is not None:
            r["idle_share"] = 1.0 - r["device_busy_ms"] / r["wall_ms"]
        print(f"{label} {name}: {json.dumps(r)}")
        if r["device_busy_ms"] is not None and \
                r["device_busy_ms"] > r["profiled_wall_ms"]:
            fail(f"{label} {name}: device busy {r['device_busy_ms']} ms "
                 f"exceeds the host wall {r['profiled_wall_ms']} ms of the "
                 f"same work")
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
    captures = res["captures"]
    print(f"decode-step captures per (batch, context) key: "
          f"{ {str(k): n for k, n in captures.items()} }")
    if sorted(captures) != sorted((b, LAUNCH_CONTEXT) for b in set(sizes)) \
            or set(captures.values()) != {1}:
        fail(f"expected one capture per batch size {sorted(set(sizes))}")
    # each capture runs the step eagerly once before it (graphs.py)
    steps = calls * (new - 1) + len(captures)
    expected = {"flash_attention": L * calls,
                "decode_attention": L * steps,
                "sgmv": sites * L * (calls + steps),
                "paged_attention": 0, "paged_prefill": 0}
    print(f"launches {launches}, expected {expected} ({calls} prefill "
          f"calls, {steps} decode steps incl. the eager run before each of "
          f"{len(captures)} captures, {L} layers, {sites} LoRA sites)")
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
           "captures": {str(k): n for k, n in captures.items()},
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"peak memory {out['peak_memory_gb']:.2f} GB on {_smi(device)}")
    out["breakdown"] = engine_breakdown(cfg, params, device)
    torch.cuda.empty_cache()
    print(f"phase 5 ok ({time.perf_counter() - t0:.1f} s)")
    return out


def eager_tokens(eng, prompts: torch.Tensor, ai: torch.Tensor, new: int,
                 **inputs) -> torch.Tensor:
    """The captured ``generate``'s oracle: the greedy tokens of a prefill
    of ``prompts`` (behind ``embeds``, over ``frame_embeds``: ``inputs``)
    on a fresh ring, then ``new - 1`` uncaptured ``decode_one`` steps.
    Returns (B, new) int32."""
    logits, cache = eng.prefill(prompts, ai, **inputs)
    pos = prompts.shape[1] + (inputs["embeds"].shape[1]
                              if inputs.get("embeds") is not None else 0)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(new - 1):
        logits, cache = eng.decode_one(tok, cache, pos + i, ai)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1)


def ring_breakdown(label: str, eng, prompts: torch.Tensor, ai: torch.Tensor,
                   device: Dict, steps: int = 16, **inputs) -> Dict:
    """Where a warm batch's time goes: a prefill of ``prompts`` (over
    ``inputs``, e.g. ``frame_embeds``) on the engine's emptied ring and
    ``steps`` replays of its captured decode step, first on the host clock
    alone (the eager prefill's wall varies from call to call: the median
    of three rounds, each kept), then again from the same state under the
    profiler for device busy, each round's wrapper launches held against
    the profiler's kernels.  Idle share = 1 - device busy / unprofiled
    host wall; a busy time above the profiled round's wall fails."""
    from repro_torch import kernels
    B, T = prompts.shape
    state: Dict = {}

    def prefill() -> None:
        cache, state["step"] = eng.ring(B)
        logits, _ = eng.prefill(prompts, ai, cache=cache, **inputs)
        state["tok"] = torch.argmax(logits, dim=-1).to(torch.int32)

    def decode() -> None:
        step = state["step"]
        step(state["tok"], torch.full((), T, dtype=torch.int32,
                                      device="cuda"), ai)
        for _ in range(steps - 1):
            step.replay()

    counts: Dict[str, Dict[str, int]] = {}

    def counted(name: str, fn):
        def run():
            before = kernels.launch_counts()
            fn()
            after = kernels.launch_counts()
            counts[name] = {k: after[k] - before[k] for k in after
                            if after[k] > before[k]}
        return run

    walls = [wall_ms(prefill) for _ in range(3)]
    res = {"prefill": {"rows": B, "tokens": T,
                       "wall_ms": statistics.median(walls),
                       "wall_ms_rounds": walls},
           "decode": {"rows": B, "steps": steps, "wall_ms": wall_ms(decode)}}

    def profile_round() -> List:
        # the prefill starts from the emptied ring: each round repeats
        # from the same state
        pre = profiled(counted("prefill", prefill))
        dec = profiled(counted("decode", decode))
        return [("prefill", counts["prefill"], pre),
                ("decode", counts["decode"], dec)]

    parts, checks = checked_rounds(label, profile_round)
    for name, _, prof in parts:
        res[name].update(prof)
    report_rounds(f"{label} breakdown", res)
    for (name, _, _), check in zip(parts, checks):
        res[name]["cross_check"] = check
    per_step(f"{label} decode step, {B} rows at positions {T}-"
             f"{T + steps - 1} (captured)", res["decode"]["wall_ms"],
             res["decode"], steps, device)
    return res


def engine_breakdown(cfg, params, device: Dict, steps: int = 16) -> Dict:
    """One warm batch of LAUNCH_BATCH fresh prompts: first its captured
    ``generate`` against an eager loop of ``decode_one`` over a fresh ring
    (equal tokens), then where its time goes (``ring_breakdown``)."""
    from repro_torch.core.engine import InferenceEngine
    eng = InferenceEngine(cfg, params, max_context=LAUNCH_CONTEXT)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    B, T = LAUNCH_BATCH, LAUNCH["prompt_len"]
    prompts = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                            device="cuda", dtype=torch.int32)
    ai = (torch.arange(B, device="cuda") % ADAPTERS).to(torch.int32)

    new = LAUNCH["max_new"]
    got, _ = eng.generate(prompts, new, ai)
    if not torch.equal(got, eager_tokens(eng, prompts, ai, new)):
        fail("captured generate and an eager decode loop emit different "
             "tokens")
    print(f"engine: {B} rows x {new} tokens of the captured generate equal "
          f"to an eager decode_one loop's; captures "
          f"{ {str(k): n for k, n in eng.captures().items()} }")
    return ring_breakdown("engine", eng, prompts, ai, device, steps)


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
    replays of phase 7 then take the same scheduling decisions."""

    def __init__(self) -> None:
        self.calls = 0

    def __call__(self) -> float:
        self.calls += 1
        return self.calls * 1e-4


# ------------------------------------------------------------- 6. overload
def overload_trace(vocab: int, seed: int):
    """The three tenants round robin, each with its own SYSTEM_PROMPT-token
    system prompt and a private suffix (prompts of OVERLOAD_PROMPT tokens),
    arriving in a burst of OVERLOAD_BURST_S; "premium" is SLO class 1 with
    a finite TTFT deadline.  Then DOOMED "std" requests with a 1 ms TTFT
    deadline, which no prefill can meet, at DOOMED_ARRIVAL_S."""
    rng = np.random.default_rng(seed)
    tenants = list(TENANTS)
    sys_prompt = {t: rng.integers(0, vocab, SYSTEM_PROMPT).astype(np.int32)
                  for t in tenants}
    burst = np.sort(rng.uniform(0.0, OVERLOAD_BURST_S, OVERLOAD_REQUESTS))
    work, prompts = [], {}
    for rid in range(OVERLOAD_REQUESTS + DOOMED):
        doomed = rid >= OVERLOAD_REQUESTS
        tenant = "std" if doomed else tenants[rid % len(tenants)]
        n = int(rng.integers(OVERLOAD_PROMPT[0], OVERLOAD_PROMPT[1] + 1))
        prompts[rid] = np.concatenate([sys_prompt[tenant], rng.integers(
            0, vocab, n - SYSTEM_PROMPT).astype(np.int32)])
        w = dict(req_id=rid, fn_id=tenant, prompt_len=n,
                 arrival=DOOMED_ARRIVAL_S if doomed else float(burst[rid]),
                 output_len=OVERLOAD_OUTPUT, slo_ttft=1e9)
        if tenant == "premium":
            w.update(slo_class=1, deadline_ttft=PREMIUM_DEADLINE_S)
        if doomed:
            w["deadline_ttft"] = 1e-3
        work.append(w)
    return work, prompts


class TimedDispatch:
    """A runtime dispatch with CUDA events around each call while its
    probe is armed (the staging copies and the graph replay)."""

    def __init__(self, dispatch, probe):
        self.dispatch, self.probe = dispatch, probe

    def __call__(self, *args):
        if not self.probe.armed:
            return self.dispatch(*args)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.dispatch(*args)
        end.record()
        self.probe.events.append((start, end))
        return out

    def _cache_size(self) -> int:
        return self.dispatch._cache_size()


class OverloadProbe:
    """Watches a runtime from outside while it serves.

    * Every block a dying slot demotes into the cached tier (preempt,
      abort, force-evict) is copied, all layers' K and V, when it is
      demoted, before the dispatch that follows; after every later decode
      chunk the pool must hold exactly those bits until the pool evicts the
      block for reuse.  A captured decode graph that read a released slot's
      stale block table would write there.
    * The host wall of every ``decode`` call that dispatched a chunk
      (planning, input staging, the graph, the token read-back,
      acceptance), and the device span of its dispatch (CUDA events from
      before the input staging to after the graph): the share of the wall
      outside that span is host work between dispatches.  The span still
      holds the gaps between the graph's kernels, so the calls of
      PROFILED_CHUNKS also run under ``torch.profiler``: the idle share is
      1 - their mean device busy (union of kernel intervals) / the mean
      wall of the unprofiled calls, as phases 4 and 5 set a profiled
      round against an unprofiled one (every chunk runs the same
      fixed-shape graph; the tracer inflates the profiled calls' wall)."""

    def __init__(self, rt):
        self.rt, self.saved = rt, {}
        self.demoted = self.verified = self.evicted = 0
        self.walls: List[float] = []
        self.events: List = []
        self.profiles: List[Dict] = []
        self.armed = False
        release, evict, decode = rt._release_slot, rt.pool.evict_hook, \
            rt.decode

        def release_and_copy(st, *, demote=False):
            release(st, demote=demote)
            if demote:
                self.copy([b for b in st.blocks
                           if rt.pool.is_cached(b) and b not in self.saved])

        def evict_and_forget(b):
            if self.saved.pop(b, None) is not None:
                self.evicted += 1
            evict(b)

        def timed_decode():
            n, got = len(self.events), {}
            self.armed = True
            if len(self.walls) in PROFILED_CHUNKS:
                prof = profiled(lambda: got.setdefault("out", decode()))
                wall = prof["profiled_wall_ms"] / 1e3
            else:
                t0 = time.perf_counter()
                got["out"] = decode()
                wall = time.perf_counter() - t0
            self.armed = False
            if len(self.events) > n:            # a chunk was dispatched
                if len(self.walls) in PROFILED_CHUNKS:
                    self.profiles.append(prof)
                self.walls.append(wall)
            self.verify()
            return got["out"]

        rt._release_slot = release_and_copy
        rt.pool.evict_hook = evict_and_forget
        rt.decode = timed_decode
        rt._decode = TimedDispatch(rt._decode, self)

    def _gather(self, ids: List[int]) -> torch.Tensor:
        """(layers, 2, K, len(ids), bs, hd): the blocks' K and V."""
        idx = torch.tensor(ids, device=self.rt.device)
        return torch.stack([torch.stack([layer["kp"].index_select(1, idx),
                                         layer["vp"].index_select(1, idx)])
                            for layer in self.rt.cache])

    def copy(self, ids: List[int]) -> None:
        if ids:
            got = self._gather(ids)
            for i, b in enumerate(ids):
                self.saved[b] = got[:, :, :, i].clone()
            self.demoted += len(ids)

    def verify(self) -> None:
        if not self.saved:
            return
        ids = sorted(self.saved)
        cur = self._gather(ids)
        want = torch.stack([self.saved[b] for b in ids], dim=3)
        diff = (cur.view(torch.uint8) != want.view(torch.uint8)) \
            .movedim(3, 0).flatten(1).any(1)       # bits, per block
        bad = [b for b, d in zip(ids, diff.tolist()) if d]
        if bad:
            fail(f"demoted blocks {bad} changed while parked in the cached "
                 f"tier (a dispatch wrote through a stale block table)")
        self.verified += len(ids)

    def idle(self) -> Dict:
        torch.cuda.synchronize()
        span = sum(s.elapsed_time(e) for s, e in self.events) / 1e3
        wall = sum(self.walls)
        out = {"decode_chunks": len(self.walls), "host_wall_s": wall,
               "dispatch_span_s": span,
               "host_share_outside_dispatch": 1.0 - span / wall}
        busy = [p["device_busy_ms"] for p in self.profiles]
        plain = [w for i, w in enumerate(self.walls)
                 if i not in PROFILED_CHUNKS]
        out["idle_share"] = None            # the profiler saw no device work
        if self.profiles and None not in busy and plain:
            b = sum(busy) / len(busy)
            w = sum(plain) / len(plain) * 1e3
            out.update(profiled_chunks=len(busy), busy_ms_per_chunk=b,
                       wall_ms_per_chunk=w, profiled_wall_ms_per_chunk=sum(
                           p["profiled_wall_ms"] for p in self.profiles)
                       / len(busy), idle_share=1.0 - b / w)
        return out


def _pct(values: List[float], q: float) -> Optional[float]:
    return float(np.percentile(values, q)) if values else None


def overload_phase(cfg, params, device: Dict) -> Dict:
    from repro_torch import kernels
    from repro_torch.core.lora import partition_lora, take_adapter
    from repro_torch.serving import (AdapterRegistry, ArtifactFault,
                                     CompileGuard, ContinuousRuntime,
                                     DispatchSlowdown, FaultPlan,
                                     PoolSqueeze, RobustConfig,
                                     ServingConfig, replay_trace,
                                     terminal_state)

    t0 = phase("phase 6: overload, Llama-2-7B full width on the card")
    torch.cuda.reset_peak_memory_stats()
    layers, names = cfg.num_layers, [f"fn{i}" for i in range(ADAPTERS)]
    work, prompts = overload_trace(cfg.vocab_size, seed=3)
    doomed = {w["req_id"] for w in work if w["req_id"] >= OVERLOAD_REQUESTS}
    burst = [w for w in work if w["req_id"] not in doomed]
    print(f"trace: {len(burst)} greedy requests from tenants "
          f"{TENANTS} in {OVERLOAD_BURST_S} s, prompts "
          f"{min(w['prompt_len'] for w in burst)}-"
          f"{max(w['prompt_len'] for w in burst)} tokens ({SYSTEM_PROMPT}-"
          f"token system prompt per tenant), {OVERLOAD_OUTPUT} output "
          f"tokens; premium: SLO class 1, TTFT deadline "
          f"{PREMIUM_DEADLINE_S} s; {len(doomed)} more at "
          f"{DOOMED_ARRIVAL_S} s with a 1 ms TTFT deadline")

    # the oracle: the burst on phase 4's ample pool, no faults, no deadlines
    rt = ContinuousRuntime(cfg, params, ServingConfig(**SERVE))
    AdapterRegistry(rt, names=names)
    oracle: Dict[int, List[int]] = {}
    with FiniteLogits() as finite:
        res_o, _ = replay_trace(
            rt, [dict(w, deadline_ttft=math.inf) for w in burst], TENANTS,
            prompts=prompts, prefill_group=SERVE["prefill_rows"],
            token_sink=oracle)
    if [terminal_state(r) for r in res_o.requests] != \
            ["finished"] * len(burst) or not finite.ok():
        fail("the ample-pool oracle did not finish every request finitely")
    del rt
    gc.collect()
    torch.cuda.empty_cache()

    scfg = ServingConfig(**OVERLOAD, robust=RobustConfig(**OVERLOAD_ROBUST))
    rt = ContinuousRuntime(cfg, params, scfg)
    reg = AdapterRegistry(rt, names=names[:3])
    plan = FaultPlan(
        artifact_faults=[ArtifactFault("adapter", name="fn3", fails=1)],
        pool_squeezes=[PoolSqueeze(**SQUEEZE)],
        slowdowns=[DispatchSlowdown(**SLOWDOWN)])
    rt.faults = plan                 # the setup load meets the plan
    slot3 = reg.load("fn3", _map_clone(take_adapter(
        partition_lora(params)[1], 3)))
    rt.faults = None
    if slot3 != 3 or rt.stats["artifact_retries"] != 1:
        fail(f"fn3's load: slot {slot3}, "
             f"{rt.stats['artifact_retries']} retries (want slot 3, 1)")
    print(f"serving: {OVERLOAD}, {OVERLOAD_ROBUST}; faults: squeeze "
          f"{SQUEEZE}, slowdown {SLOWDOWN}, fn3's first load fails")
    probe = OverloadProbe(rt)
    sink: Dict[int, List[int]] = {}
    with FiniteLogits() as finite, CompileGuard(
            {"decode": 1, "prefill": 1}, runtime=rt) as guard:
        kernels.reset_launches()
        t_run = time.perf_counter()
        res, events = replay_trace(
            rt, work, TENANTS, prompts=prompts,
            prefill_group=SERVE["prefill_rows"], faults=plan,
            token_sink=sink, collect_events=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = kernels.launch_counts()
        dispatched = (rt.stats["prefill_chunks"], rt.stats["decode_chunks"])
        idle = probe.idle()
        books = rt.check_invariants(res.requests)
        pins = reg.pin_counts()
        abort = abort_check(rt, reg, cfg, probe)
    report = guard.report()
    print(f"CompileGuard: {json.dumps(report)}")
    if report["decode_compiles"] != 1 or report["prefill_compiles"] != 1:
        fail(f"dispatches captured more than once: {report}")

    states = {r.req_id: terminal_state(r) for r in res.requests}
    faults = plan.report()
    stats = {k: rt.stats[k] for k in (
        "preemptions", "retries", "resume_prefix_hits", "demoted_blocks",
        "rejected_deadline", "abandoned", "aborted", "stall_steps",
        "injected_pool_squeezes", "artifact_retries")}
    print(f"terminal states {books['terminal']}; counters {stats}; faults "
          f"{faults}")
    if None in states.values():
        fail(f"requests in no terminal state: {states}")
    if books["problems"] or books["pool"]["live"] or pins:
        fail(f"books after the drain: {books}, pins {pins}")
    if any(sq.held or not sq.done for sq in plan.pool_squeezes):
        fail("a pool squeeze still holds blocks")
    if faults["artifact_failures"] != 1 or faults["pool_squeezes"] < 1 \
            or faults["slowed_dispatches"] < 1:
        fail(f"a fault never fired: {faults}")
    if stats["preemptions"] < 1 or stats["retries"] < 1 \
            or stats["resume_prefix_hits"] < 1:
        fail(f"no preemption, requeue or prefix-cache resume: {stats}")
    resumed = [r for r in res.requests
               if r.breakdown.get("resumed_covered_tokens", 0.0) > 0]
    for r in resumed:
        if not r.breakdown["resume_recomputed_tokens"] < r.prompt_len:
            fail(f"request {r.req_id} resumed with a prefix hit but "
                 f"recomputed {r.breakdown['resume_recomputed_tokens']} of "
                 f"its {r.prompt_len} prompt tokens")
    shed = {r.req_id for r in res.requests
            if "rejected_deadline" in r.breakdown}
    if shed != doomed:
        fail(f"shed {sorted(shed)}, want exactly {sorted(doomed)}")
    finished = [r.req_id for r in res.requests
                if states[r.req_id] == "finished"]
    differ = [rid for rid in finished if sink.get(rid) != oracle[rid]]
    if differ:
        fail(f"requests {differ} emit other tokens than on an ample pool "
             f"with no faults")
    if not finite.ok():
        fail("non-finite logits in the overload replay")
    if probe.demoted < 1 or probe.verified < 1:
        fail(f"no demoted block was watched ({probe.demoted} demoted)")
    prefills = dispatched[0] + 2 + 1         # + warmup's two, capture's
    steps = (dispatched[1] + 2 + 1) * scfg.decode_chunk
    expected = expected_launches(cfg, prefills, steps)
    print(f"launches {launches}, expected {expected} ({prefills} prefill "
          f"dispatches, {steps} decode steps incl. warmup and the eager run "
          f"before each capture)")
    if launches != expected:
        fail("launch counts differ from layers x dispatches x sites")

    ttft = {t: [r.first_token - r.arrival for r in res.requests
                if r.fn_id == t and states[r.req_id] == "finished"]
            for t in TENANTS}
    premium = ttft["premium"]
    recomputed = sum(r.breakdown["resume_recomputed_tokens"]
                     for r in resumed)
    cold = sum(r.prompt_len for r in resumed)
    out = {
        "requests": len(work), "terminal": books["terminal"], **stats,
        "faults": faults, "finished_equal_to_oracle": len(finished),
        "ttft_s": {t: {"p50": _pct(v, 50), "p95": _pct(v, 95), "n": len(v)}
                   for t, v in ttft.items()},
        "premium_attainment_deadline": sum(
            x <= PREMIUM_DEADLINE_S for x in premium) / max(len(premium), 1),
        "premium_attainment_slo": sum(
            x <= TTFT_SLO_S for x in premium) / max(len(premium), 1),
        "resumed_with_hit": len(resumed), "resume_recomputed_tokens":
        recomputed, "resume_cold_tokens": cold, "shed": sorted(shed),
        "replay_clock_s": max(r.done for r in res.requests
                              if r.done >= 0),
        "replay_wall_s": wall, "decode_chunks": idle,
        "demoted_blocks_watched": probe.demoted,
        "block_checks": probe.verified, "watched_blocks_evicted":
        probe.evicted, "launches": launches, "compile_guard": report,
        "events": len(events), "abort": abort,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    for t, v in out["ttft_s"].items():
        print(f"TTFT {t}: p50 {v['p50']:.4f} s, p95 {v['p95']:.4f} s over "
              f"{v['n']} finished (replay clock)")
    print(f"premium attainment: {out['premium_attainment_slo']:.3f} within "
          f"the {TTFT_SLO_S} s SLO, {out['premium_attainment_deadline']:.3f}"
          f" within its {PREMIUM_DEADLINE_S} s deadline")
    print(f"preemptions {stats['preemptions']}, retries {stats['retries']},"
          f" resume hits {stats['resume_prefix_hits']}: {len(resumed)} "
          f"resumes recomputed {recomputed:.0f} prompt tokens against "
          f"{cold} cold; shed {len(shed)}; {len(finished)} finished "
          f"requests' tokens equal to the ample pool's; {probe.demoted} "
          f"demoted blocks watched over {probe.verified} block checks "
          f"({probe.evicted} evicted for reuse) unchanged")
    profiled_idle = ("not measured" if idle["idle_share"] is None else
                     f"{idle['busy_ms_per_chunk']:.2f} ms busy a chunk "
                     f"against {idle['wall_ms_per_chunk']:.2f} ms of "
                     f"unprofiled wall, idle share {idle['idle_share']:.3f} "
                     f"(profiled wall {idle['profiled_wall_ms_per_chunk']:.2f}"
                     f" ms)")
    print(f"overload replay: wall {wall:.2f} s, replay clock "
          f"{out['replay_clock_s']:.2f} s; {idle['decode_chunks']} decode "
          f"chunks: host wall {idle['host_wall_s']:.3f} s, dispatch span "
          f"{idle['dispatch_span_s']:.3f} s (host share outside the "
          f"dispatch {idle['host_share_outside_dispatch']:.3f}); "
          f"chunks {PROFILED_CHUNKS.start}-{PROFILED_CHUNKS.stop - 1} "
          f"under the profiler: "
          f"{profiled_idle} on {_smi(device)}")
    del rt, reg, guard, probe
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 6 ok ({out['phase_s']:.1f} s)")
    return out


def abort_check(rt, reg, cfg, probe: OverloadProbe) -> Dict:
    """On the drained overload runtime: request A alone; then A again beside
    B, one decode chunk, and B aborted.  B's blocks and pin must be
    released and its completed blocks demoted (B's prompt of 398 tokens
    plus the chunk's 4 completes block 24 with 2 decoded tokens), and A
    must emit the tokens it emitted alone (now starting its prefill past
    the prefix it shares with its first run)."""
    from repro_torch.serving import ServeRequest, terminal_state
    rng = np.random.default_rng(11)
    a_prompt = rng.integers(0, cfg.vocab_size, 300).astype(np.int32)
    b_prompt = rng.integers(0, cfg.vocab_size, 398).astype(np.int32)
    bs = rt.scfg.block_size

    def drain(sid: int, toks: List[int]) -> List[int]:
        while rt.slots.states[sid] is not None:
            toks.extend(rt.decode().emitted.get(sid, []))
        return toks

    res = rt.try_admit([ServeRequest(prompt=a_prompt, adapter="fn1",
                                     max_new_tokens=16)])
    alone = drain(res.slot_ids[0], list(res.first_tokens))
    a = ServeRequest(prompt=a_prompt, adapter="fn1", max_new_tokens=16)
    b = ServeRequest(prompt=b_prompt, adapter="fn0", max_new_tokens=32)
    res = rt.try_admit([a, b])
    if res is None or res.shared_blocks[0] < 1:
        fail(f"abort check: admission {res}")
    together = [res.first_tokens[0]] + rt.decode().emitted[res.slot_ids[0]]
    st = rt.slots.states[res.slot_ids[1]]
    blocks, done = list(st.blocks), st.pos // bs
    demoted = rt.stats["demoted_blocks"]
    if not rt.abort(b.request.req_id) or rt.slots.states[st.sid] is not None:
        fail("abort did not release B's slot")
    if reg.pin_counts() != {reg.slot_of("fn1"): 1}:
        fail(f"pins after the abort: {reg.pin_counts()}")
    if not all(rt.pool.is_cached(x) and rt.prefix.has_block(x)
               for x in blocks[:done]) or any(
            rt.pool.refcount(x) or rt.pool.is_cached(x)
            for x in blocks[done:]):
        fail("B's completed blocks are not all cached, or the rest not free")
    if rt.stats["demoted_blocks"] - demoted < 1:
        fail("the block B completed with decoded tokens was not demoted")
    together = drain(res.slot_ids[0], together)
    if together != alone:
        fail(f"A's tokens beside an aborted B differ from A's alone: "
             f"{together} vs {alone}")
    books = rt.check_invariants()
    if books["problems"] or books["pool"]["live"] or reg.pin_counts() \
            or terminal_state(b.request) != "aborted":
        fail(f"books after the abort check: {books}, B "
             f"{terminal_state(b.request)}")
    print(f"abort: B released ({len(blocks)} blocks, {done} completed now "
          f"cached, {rt.stats['demoted_blocks'] - demoted} newly demoted), "
          f"its pin dropped; A ({len(together)} tokens, prefill past "
          f"{res.shared_blocks[0]} shared blocks) equal to A alone")
    return {"b_blocks": len(blocks), "b_completed_cached": done,
            "newly_demoted": rt.stats["demoted_blocks"] - demoted,
            "a_tokens": len(together),
            "a_shared_blocks": res.shared_blocks[0]}


# --------------------------------------------------------------- 7. parity
RUNTIME_KERNELS = ("sgmv", "paged_attention", "paged_prefill")


def replay_on_both(label: str, cfg, params, scfg: Dict, trace,
                   sampling=None,
                   kernels_used=RUNTIME_KERNELS) -> Dict[str, Dict]:
    """The trace through a runtime on the card (kernels) and one on the
    CPU (plain versions) under the same deterministic clock: the same
    requests must be admitted and every token stream must be equal, the
    card must launch ``kernels_used`` (the runtime's kernels that the
    stack has layers for) and no other, and the CPU none.  Returns
    device -> the run's counts."""
    from repro_torch import kernels
    from repro_torch.serving import (ContinuousRuntime, ServingConfig,
                                     replay_trace)
    work, prompts, fn_adapter = trace
    sinks, runs = {}, {}
    for device in ("cuda", "cpu"):
        rt = ContinuousRuntime(cfg, _to(params, device),
                               ServingConfig(**scfg), device=device,
                               timer=StepClock())
        kernels.reset_launches()
        sinks[device] = {}
        res, _ = replay_trace(rt, work, fn_adapter, prompts=prompts,
                              token_sink=sinks[device], sampling=sampling)
        runs[device] = {
            "launches": kernels.launch_counts(),
            "admitted": sorted(r.req_id for r in res.requests
                               if r.first_token >= 0),
            "stall_steps": rt.stats["stall_steps"],
            "sampled_tokens": rt.stats["sampled_tokens"],
            "reclaimed_blocks": rt.stats["reclaimed_blocks"]}
    card = runs["cuda"]["launches"]
    if min(card[k] for k in kernels_used) <= 0 or \
            any(n for k, n in card.items() if k not in kernels_used) or \
            max(runs["cpu"]["launches"].values()) != 0:
        fail(f"{label} launches: card {card}, CPU "
             f"{runs['cpu']['launches']}")
    if runs["cuda"]["admitted"] != runs["cpu"]["admitted"]:
        fail(f"{label}: admitted sets differ: {runs}")
    if sinks["cuda"] != sinks["cpu"]:
        diff = [k for k in sinks["cpu"]
                if sinks["cuda"].get(k) != sinks["cpu"][k]]
        fail(f"{label}: token streams differ for requests {diff}")
    n = sum(len(v) for v in sinks["cpu"].values())
    print(f"{label} runtime: {len(sinks['cpu'])} requests, {n} tokens "
          f"({runs['cuda']['sampled_tokens']} sampled) equal on card and "
          f"CPU; stall steps {runs['cuda']['stall_steps']}, reclaimed "
          f"blocks {runs['cuda']['reclaimed_blocks']}; card launches {card}")
    runs["cuda"]["requests"], runs["cuda"]["tokens"] = len(sinks["cpu"]), n
    return runs


def engine_launches(cfg, calls: int, steps: int) -> Dict[str, int]:
    """Launches of ``calls`` ring prefills and ``steps`` ring decode
    steps: one flash or ring-decode kernel per ATTN layer, one SGMV per
    LoRA site (q/k/v/o of an ATTN layer, in/out of a REC or SSD block).
    An encoder-decoder's prefill (over frames) adds a flash per encoder
    layer and per cross-attention, its decode step a ring decode per
    cross-attention; neither carries LoRA."""
    paged = expected_launches(cfg, calls, steps)
    attn = cfg.layer_kinds.count("attn")
    cross = attn if cfg.cross_attention else 0
    return {"flash_attention": (attn + cross + cfg.encoder_layers) * calls,
            "decode_attention": (attn + cross) * steps,
            "sgmv": paged["sgmv"], "paged_attention": 0, "paged_prefill": 0}


def generate_on_both(label: str, cfg, params, T: int, new: int,
                     prefix: int = 0) -> Dict:
    """``InferenceEngine.generate`` of 3 rows of T tokens, one adapter
    each, ``new`` greedy tokens, on the card and on the CPU, behind
    ``prefix`` random image-patch embeddings where it is > 0, over
    ``encoder_seq`` random frame embeddings on a cross-attention model:
    equal tokens, and on the card one flash prefill per ATTN layer (and
    per encoder layer and cross-attention) and a decode step per token
    (captured once, after one eager run: graphs.py)."""
    from repro_torch import kernels
    from repro_torch.core.engine import InferenceEngine
    B = 3
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, T)).astype(np.int32))
    embeds = torch.from_numpy((rng.standard_normal(
        (B, prefix, cfg.d_model)) * 0.02).astype(np.float32)) \
        if prefix else None
    frames = torch.from_numpy(rng.standard_normal(
        (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)) \
        if cfg.cross_attention else None
    out = {}
    for device in ("cuda", "cpu"):
        eng = InferenceEngine(cfg, _to(params, device), max_context=40,
                              device=device)
        kernels.reset_launches()
        got, _ = eng.generate(
            toks.to(device), new, adapter_idx=torch.arange(
                B, dtype=torch.int32, device=device),
            embeds=None if embeds is None else embeds.to(device),
            frame_embeds=None if frames is None else frames.to(device))
        out[device] = {"tokens": got.cpu().tolist(),
                       "launches": kernels.launch_counts()}
    want = engine_launches(cfg, 1, new)
    if out["cuda"]["launches"] != want or \
            max(out["cpu"]["launches"].values()) != 0:
        fail(f"{label} engine launches: card {out['cuda']['launches']} "
             f"(expected {want}), CPU {out['cpu']['launches']}")
    if out["cuda"]["tokens"] != out["cpu"]["tokens"]:
        fail(f"{label} engine tokens differ: card {out['cuda']['tokens']}, "
             f"CPU {out['cpu']['tokens']}")
    print(f"{label} engine generate: {B} rows x {new} greedy tokens over "
          f"{T}-token prompts (window {cfg.sliding_window}"
          + (f", behind {prefix} image-prefix embeddings" if prefix else "")
          + (f", over {cfg.encoder_seq} frame embeddings" if frames
             is not None else "")
          + f") equal on card and CPU; card launches "
          f"{out['cuda']['launches']}")
    return out["cuda"]


def smoke_params(arch: str, seed: int):
    """SMOKE config of ``arch`` in float32 with a 3-adapter rank-8 bank on
    its LoRA targets, random from ``seed`` (LoRA B drawn N(0, 0.1)), on
    the CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import transformer as tf
    cfg = get_smoke(arch)
    cfg = cfg.with_(dtype="float32", lora=dataclasses.replace(
        cfg.lora, rank=8, alpha=16.0, num_adapters=3))
    gen = torch.Generator()
    gen.manual_seed(seed)
    return cfg, tf.init_params(cfg, gen, "cpu", lora_adapters=3,
                               lora_b_scale=0.1)


def parity_phase() -> Dict:
    from repro_torch.core.sampling import SamplingParams, \
        philox_uniform_torch

    t0 = phase("phase 7: SMOKE float32, card (kernels) vs CPU (plain "
               "versions): runtime replay, greedy and sampled; engine "
               "generate; Llama, then Mixtral (MoE, window 16), Qwen2.5 "
               "(QKV bias), RecurrentGemma and Mamba2 (state rows and "
               "ring state), PaliGemma (image prefix), Whisper (encoder, "
               "cross-attention)")
    scfg = dict(num_slots=4, block_size=8, num_blocks=24,
                max_blocks_per_slot=6, prefill_chunk=16, decode_chunk=4)
    cfg, params = smoke_params("llama2_7b", seed=1)
    trace = shared_prefix_trace(9, 3, 16, 30, 8, cfg.vocab_size, seed=7)
    # five sampled requests (temperature alone, top-k, top-p, both) take
    # the sort/top-k/top-p/Philox path; the rest stay greedy
    sampling = {1: SamplingParams(temperature=0.8, top_k=20, top_p=0.9,
                                  seed=5),
                4: SamplingParams(temperature=1.0, seed=11),
                5: SamplingParams(temperature=0.6, top_k=7),
                6: SamplingParams(temperature=1.3, top_p=0.75, seed=2 ** 31 - 1),
                8: SamplingParams(temperature=0.9, top_k=3, top_p=0.5)}
    runs = replay_on_both("Llama SMOKE", cfg, params, scfg, trace, sampling)
    if runs["cuda"]["sampled_tokens"] != len(sampling) * 8:
        fail(f"expected {len(sampling) * 8} sampled tokens, the card drew "
             f"{runs['cuda']['sampled_tokens']}")
    # the sampled rows' uniforms: counter 0 (prefill) .. 7, card vs CPU
    seeds = torch.tensor([sp.resolve_seed(rid) for rid, sp in
                          sorted(sampling.items())], dtype=torch.int32)
    ctr = torch.arange(8, dtype=torch.int32)
    sd, ct = seeds[:, None].expand(-1, 8), ctr[None].expand(len(seeds), -1)
    u_card = philox_uniform_torch(sd.cuda(), ct.cuda()).cpu()
    u_cpu = philox_uniform_torch(sd, ct)
    if not torch.equal(u_card.view(torch.int32), u_cpu.view(torch.int32)):
        fail("Philox uniforms differ between the card and the CPU")
    print(f"Philox: {u_cpu.numel()} uniforms of the sampled rows equal bit "
          f"for bit on card and CPU")
    engine = generate_on_both("Llama SMOKE", cfg, params, T=24, new=8)

    # Mixtral SMOKE: sparse MoE, a 16-token window; its replay's decode
    # chunks reclaim blocks, and its prompts run past the window
    cfg, params = smoke_params(MIXTRAL, seed=2)
    moe = replay_on_both(
        "Mixtral SMOKE", cfg, params, scfg,
        shared_prefix_trace(9, 3, 16, 30, 12, cfg.vocab_size, seed=8))
    if not 0 < moe["cuda"]["reclaimed_blocks"] == \
            moe["cpu"]["reclaimed_blocks"]:
        fail(f"Mixtral SMOKE reclaimed blocks: card "
             f"{moe['cuda']['reclaimed_blocks']}, CPU "
             f"{moe['cpu']['reclaimed_blocks']}")
    moe["cuda"]["engine"] = generate_on_both("Mixtral SMOKE", cfg, params,
                                             T=24, new=8)

    # the stacks with REC/SSD state rows: RecurrentGemma SMOKE (REC, REC,
    # ATTN; window 16, so its replay reclaims) and Mamba2 SMOKE (SSD only:
    # no paged kernel runs)
    cfg, params = smoke_params(RGEMMA, seed=3)
    rgemma = replay_on_both(
        "RecurrentGemma SMOKE", cfg, params, scfg,
        shared_prefix_trace(9, 3, 16, 30, 12, cfg.vocab_size, seed=9))
    # ... and their generate over ring state: 29-token prompts, past
    # RecurrentGemma's 16-slot ring and not a multiple of the scans' chunk
    rgemma["cuda"]["engine"] = generate_on_both(
        "RecurrentGemma SMOKE", cfg, params, T=29, new=8)
    cfg, params = smoke_params(MAMBA, seed=4)
    mamba = replay_on_both(
        "Mamba2 SMOKE", cfg, params, scfg,
        shared_prefix_trace(9, 3, 16, 60, 12, cfg.vocab_size, seed=10),
        kernels_used=("sgmv",))
    mamba["cuda"]["engine"] = generate_on_both("Mamba2 SMOKE", cfg, params,
                                               T=29, new=8)

    # Qwen2.5 SMOKE: QKV biases (drawn nonzero by init_params)
    cfg, params = smoke_params("qwen2_5_3b", seed=5)
    qwen = replay_on_both(
        "Qwen2.5 SMOKE", cfg, params, scfg,
        shared_prefix_trace(9, 3, 16, 30, 8, cfg.vocab_size, seed=11))
    qwen["cuda"]["engine"] = generate_on_both("Qwen2.5 SMOKE", cfg, params,
                                              T=24, new=8)
    # PaliGemma SMOKE behind its 8 image-prefix embeddings (prefix-LM)
    cfg, params = smoke_params(PALIGEMMA, seed=6)
    pali = generate_on_both("PaliGemma SMOKE", cfg, params, T=12, new=8,
                            prefix=cfg.num_image_tokens)
    # Whisper SMOKE over its 16 frame embeddings (encoder, cross caches)
    cfg, params = smoke_params(WHISPER, seed=7)
    whisper = generate_on_both("Whisper SMOKE", cfg, params, T=12, new=8)
    print(f"phase 7 ok ({time.perf_counter() - t0:.1f} s)")
    return {**runs["cuda"], "engine": engine, "mixtral_smoke": moe["cuda"],
            "recurrentgemma_smoke": rgemma["cuda"],
            "mamba2_smoke": mamba["cuda"], "qwen2_5_smoke": qwen["cuda"],
            "paligemma_smoke": pali, "whisper_smoke": whisper}


# -------------------------------------------------------------- 8. Mixtral
def expected_reclaimed(prompt_len: int, output: int, window: int,
                       bs: int, chunk: int) -> int:
    """Blocks a request reclaims on an ample pool.  Reclamation runs after
    every accepted decode chunk that does not finish the request: with
    ``chunk`` tokens a chunk and ``output - 1`` tokens to decode after
    the prefill's, the last such chunk leaves the slot at position
    ``prompt_len + chunk * (ceil((output - 1) / chunk) - 1)``, and every
    logical block below ``(pos - window + 1) // bs`` is released then."""
    pos = prompt_len + chunk * (-(-(output - 1) // chunk) - 1)
    return max((pos - window + 1) // bs, 0)


def check_chrome_trace(path: Path) -> int:
    """Parse a written Chrome trace; its timestamps must be monotone on
    every track.  Returns the number of events."""
    events = json.loads(path.read_text())["traceEvents"]
    last: Dict[int, float] = {}
    for e in events:
        if e["ph"] == "M":
            continue
        if e["ts"] < last.get(e["tid"], -1.0) or e.get("dur", 0) < 0:
            fail(f"{path}: timestamps not monotone on track {e['tid']}")
        last[e["tid"]] = e["ts"]
    return len(events)


def moe_alone(params, cfg, rows: int) -> Dict:
    """Device time of every layer's MoE MLP alone on (1, rows, d_model)
    random activations, eager, under the profiler: the share of a
    dispatch that the "moe" kind stands for (its products show up as
    "matmul" and its elementwise ops as "other" in a dispatch)."""
    from repro_torch.models.moe import apply_moe
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    h = _randn(gen, 1, rows, cfg.d_model, dtype=cfg.torch_dtype)

    def run() -> None:
        for lp in params["layers"]:
            apply_moe(lp["moe"], cfg, h)

    run()
    return profiled(run)


def mixtral_bounds(cfg, params, scfg, prompt_len: int) -> Dict:
    """Least times of one prefill dispatch and one decode step of the
    breakdown on this card: weights read once (the embedding table
    aside: only its rows are gathered), a decode step's windowed K/V, and
    the operations of the backbone products (every expert over every row,
    as the port computes them, and only the chosen experts' share) and of
    attention, averaged over the ``prompt_len``-token admissions."""
    D, F, E, k = cfg.d_model, cfg.d_ff, cfg.num_experts, \
        cfg.experts_per_token
    H, K, hd, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, \
        cfg.num_layers
    w = cfg.sliding_window
    weights = sum(t.numel() * t.element_size() for t in _leaves(params)) \
        - params["embed"].numel() * params["embed"].element_size()
    attn_w = D * H * hd + 2 * D * K * hd + H * hd * D
    per_token = {"every": L * (attn_w + E * 3 * D * F + D * E),
                 "active": L * (attn_w + k * 3 * D * F + D * E)}
    # decode: 8 rows one token each over min(pos + 1, window) keys
    B = scfg.num_slots
    keys = min(prompt_len + 1, w)
    kv = L * B * keys * K * hd * 2 * 2
    dec_ops = 2 * B * per_token["every"] + L * 4 * hd * H * B * keys
    # prefill: prefill_rows x prefill_chunk tokens a dispatch; pairs of
    # the whole admission spread over its dispatches
    rows = scfg.prefill_rows * scfg.prefill_chunk
    n_disp = -(-prompt_len // scfg.prefill_chunk)
    pairs = sum(min(p + 1, w) for p in range(prompt_len)) / n_disp \
        * scfg.prefill_rows
    attn_ops = L * 4 * hd * H * pairs
    out = {}
    for name, nbytes, ops, active in (
            ("decode_step", weights + kv, dec_ops,
             2 * B * per_token["active"] + L * 4 * hd * H * B * keys),
            ("prefill_dispatch", weights, 2 * rows * per_token["every"]
             + attn_ops, 2 * rows * per_token["active"] + attn_ops)):
        b = bound(nbytes, ops, torch.bfloat16)
        b["active_expert_ops"] = int(active)
        b["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        b["ops_ms"] = ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3
        out[name] = b
    return out


def mixtral_phase(device: Dict) -> Dict:
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.models.config import LoRAConfig
    from repro_torch.serving import (AdapterRegistry, CompileGuard,
                                     ContinuousRuntime, ServingConfig,
                                     Telemetry, replay_trace,
                                     terminal_state, write_metrics_json)

    t0 = phase(f"phase 8: serve Mixtral-8x22B at full width "
               f"({MIXTRAL_LAYERS} of 56 layers) on the card")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory still allocated from earlier phases: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    torch.cuda.reset_peak_memory_stats()
    full = get_config(MIXTRAL)
    cfg = full.with_(num_layers=MIXTRAL_LAYERS, lora=LoRAConfig(
        rank=16, alpha=32.0, num_adapters=ADAPTERS))
    window, names = cfg.sliding_window, [f"fn{i}" for i in range(ADAPTERS)]
    print(f"model: {cfg.name}, {cfg.num_layers} of {full.num_layers} layers "
          f"(depth cut), d_model {cfg.d_model}, {cfg.num_heads} heads over "
          f"{cfg.num_kv_heads} kv heads x {cfg.head_dim_}, d_ff {cfg.d_ff}, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token}, window "
          f"{window}, vocab {cfg.vocab_size}, {cfg.dtype}; LoRA rank "
          f"{cfg.lora.rank} on {'/'.join(cfg.lora.targets)}, bank of "
          f"{ADAPTERS}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t_init = time.perf_counter()
    params = tf.init_params(cfg, gen, "cuda", lora_adapters=ADAPTERS)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"weights: {n_bytes / 1e9:.2f} GB random from seed 0 in "
          f"{time.perf_counter() - t_init:.1f} s")

    scfg = ServingConfig(**MIXTRAL_SERVE)
    tele = Telemetry()
    rt = ContinuousRuntime(cfg, params, scfg, telemetry=tele)
    reg = AdapterRegistry(rt, names=names)
    work, prompts = system_prompt_trace(
        cfg.vocab_size, MIXTRAL_REQUESTS, MIXTRAL_PROMPT, MIXTRAL_OUTPUT,
        seed=0)
    fn_adapter = {n: n for n in names}
    print(f"serving: {MIXTRAL_SERVE}; trace: {len(work)} greedy requests, "
          f"2 per adapter, prompts {min(w['prompt_len'] for w in work)}-"
          f"{max(w['prompt_len'] for w in work)} tokens ({SYSTEM_PROMPT}-"
          f"token system prompt per adapter), {MIXTRAL_OUTPUT} output "
          f"tokens, arrivals 20 ms apart")
    sink: Dict[int, List[int]] = {}
    with FiniteLogits() as finite, CompileGuard(
            {"decode": 1, "prefill": 1}, runtime=rt) as guard:
        kernels.reset_launches()
        t_run = time.perf_counter()
        res, _ = replay_trace(rt, work, fn_adapter, prompts=prompts,
                              prefill_group=scfg.prefill_rows,
                              token_sink=sink, telemetry=tele)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    report = guard.report()
    print(f"CompileGuard: {json.dumps(report)}")
    if report["decode_compiles"] != 1 or report["prefill_compiles"] != 1:
        fail(f"Mixtral dispatches captured more than once: {report}")
    states = [terminal_state(r) for r in res.requests]
    if states != ["finished"] * len(work):
        fail(f"not every Mixtral request finished: {states}")
    if any(len(sink[w["req_id"]]) != MIXTRAL_OUTPUT for w in work):
        fail("a Mixtral request emitted the wrong number of tokens")
    books = rt.check_invariants(res.requests)
    if books["pool"]["live"] != 0 or books["slots_active"] != 0:
        fail(f"blocks or slots still held after the drain: {books}")
    if not finite.ok():
        fail("non-finite logits during the Mixtral replay")
    for layer in rt.cache:
        for pool in layer.values():
            if not bool(torch.isfinite(pool).all()):
                fail("non-finite entries in a Mixtral KV pool")

    layers, sites = cfg.num_layers, len(cfg.lora.targets)
    prefills = rt.stats["prefill_chunks"] + 2 + 1   # + warmup, capture
    steps = (rt.stats["decode_chunks"] + 2 + 1) * scfg.decode_chunk
    expected = expected_launches(cfg, prefills, steps)
    print(f"launches {launches}, expected {expected} ({prefills} prefill "
          f"dispatches, {steps} decode steps incl. warmup and the eager run "
          f"before each capture, {layers} layers, {sites} LoRA sites)")
    if launches != expected:
        fail("Mixtral launch counts differ from layers x dispatches x sites")

    # the reclamation rule, request by request
    per_req = {w["req_id"]: expected_reclaimed(
        w["prompt_len"], MIXTRAL_OUTPUT, window, scfg.block_size,
        scfg.decode_chunk) for w in work}
    last_pos = {w["req_id"]: w["prompt_len"] + scfg.decode_chunk * (
        -(-(MIXTRAL_OUTPUT - 1) // scfg.decode_chunk) - 1) for w in work}
    for rid, n in per_req.items():
        print(f"req {rid}: prompt {work[rid]['prompt_len']}, last "
              f"reclaiming chunk at position {last_pos[rid]}: "
              f"({last_pos[rid]} - {window} + 1) // {scfg.block_size} = {n} "
              f"blocks")
    want_reclaimed = sum(per_req.values())
    got_reclaimed = rt.stats["reclaimed_blocks"]
    print(f"reclaimed blocks: {got_reclaimed}, rule {want_reclaimed}")
    if got_reclaimed <= 0 or got_reclaimed != want_reclaimed:
        fail(f"reclaimed {got_reclaimed} blocks, the rule gives "
             f"{want_reclaimed}")
    high = rt.pool.high_water

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    trace_path = out_dir / "mixtral_trace.json"
    metrics_path = out_dir / "mixtral_metrics.json"
    tele.write_chrome_trace(str(trace_path))
    write_metrics_json(rt.metrics_snapshot(), str(metrics_path))
    n_events = check_chrome_trace(trace_path)
    metrics = json.loads(metrics_path.read_text())
    if metrics["counters"]["reclaimed_blocks"] != got_reclaimed:
        fail(f"{metrics_path}: reclaimed_blocks "
             f"{metrics['counters']['reclaimed_blocks']} != {got_reclaimed}")
    print(f"telemetry: {trace_path.relative_to(ROOT)} ({n_events} events, "
          f"monotone on every track), {metrics_path.relative_to(ROOT)} "
          f"({len(metrics['counters'])} counters, host bubble fraction "
          f"{metrics['host_bubble_fraction']:.3f})")

    m = rt.metrics.histogram
    ttft, tpot = m("ttft_s").summary(), m("tpot_s").summary()
    print(f"TTFT p50 {ttft['p50']:.3f} s, TPOT p50 {tpot['p50'] * 1e3:.2f} "
          f"ms (replay clock), replay wall {wall:.1f} s, peak memory "
          f"{peak:.2f} GB allocated on {_smi(device)}; pool high water "
          f"{high} blocks")

    # the same trace without reclamation: equal tokens, a higher peak
    rt2 = ContinuousRuntime(cfg, params, ServingConfig(
        **MIXTRAL_SERVE, window_reclamation=False))
    AdapterRegistry(rt2, names=names)
    keep_sink: Dict[int, List[int]] = {}
    replay_trace(rt2, work, fn_adapter, prompts=prompts,
                 prefill_group=scfg.prefill_rows, token_sink=keep_sink)
    high_keep = rt2.pool.high_water
    if rt2.stats["reclaimed_blocks"] != 0:
        fail("the runtime without reclamation reclaimed blocks")
    if keep_sink != sink:
        fail(f"tokens differ from the runtime without reclamation for "
             f"{[k for k in sink if sink[k] != keep_sink.get(k)]}")
    if not high < high_keep:
        fail(f"peak blocks in use {high} with reclamation, {high_keep} "
             f"without: not lower")
    print(f"without reclamation: {len(keep_sink)} requests' tokens equal; "
          f"peak blocks in use {high} with reclamation against {high_keep} "
          f"without")
    del rt2
    gc.collect()
    torch.cuda.empty_cache()

    bounds = mixtral_bounds(cfg, params, scfg, MIXTRAL_BREAKDOWN_PROMPT)
    res_bd = breakdown(rt, cfg, device, prompt_len=MIXTRAL_BREAKDOWN_PROMPT)
    moe = {"decode_step": moe_alone(params, cfg, scfg.num_slots),
           "prefill_dispatch": moe_alone(
               params, cfg, scfg.prefill_rows * scfg.prefill_chunk)}
    for name, b in bounds.items():
        print(f"bound, {name}: {b['bound_ms']:.2f} ms ({b['bound_by']}: "
              f"{b['bytes'] / 1e9:.1f} GB -> {b['bytes_ms']:.2f} ms, "
              f"{b['ops'] / 1e12:.2f} TFLOP every-expert -> "
              f"{b['ops_ms']:.2f} ms; {b['active_expert_ops'] / 1e12:.2f} "
              f"TFLOP with only the chosen experts); moe alone "
              f"{moe[name]['device_busy_ms']:.2f} ms device "
              f"({json.dumps(moe[name]['device_ms_by_kind'])})")
    if not finite.ok():
        fail("non-finite logits during the Mixtral breakdown")
    del rt, reg, guard, params
    gc.collect()
    torch.cuda.empty_cache()
    out = {"layers": layers, "requests": len(work), "replay_wall_s": wall,
           "ttft_p50_s": ttft["p50"], "tpot_p50_s": tpot["p50"],
           "peak_memory_gb": peak, "weights_gb": n_bytes / 1e9,
           "launches": launches, "compile_guard": report,
           "reclaimed_blocks": got_reclaimed, "reclaimed_rule": per_req,
           "pool_high_water": high, "pool_high_water_no_reclaim": high_keep,
           "trace_events": n_events, "breakdown": res_bd, "bounds": bounds,
           "moe_alone": moe, "phase_s": time.perf_counter() - t0}
    print(f"phase 8 ok ({out['phase_s']:.1f} s)")
    return out


# --------------------------------------------- 9-10. stacks with state rows
def state_model(arch: str, layers: Optional[int] = None):
    """``arch`` at full width (and depth unless ``layers``) with a
    4-adapter rank-16 bank on its LoRA targets, random from seed 0 on the
    card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    full = get_config(arch)
    cfg = full.with_(num_layers=layers or full.num_layers,
                     lora=dataclasses.replace(full.lora,
                                              num_adapters=ADAPTERS))
    kinds = {k: cfg.layer_kinds.count(k) for k in sorted(set(
        cfg.layer_kinds))}
    cut = "no depth cut" if cfg.num_layers == full.num_layers else \
        f"depth cut from {full.num_layers}"
    print(f"model: {cfg.name}, {cfg.num_layers} layers {kinds} ({cut}), "
          f"d_model {cfg.d_model}, "
          + (f"{cfg.num_heads} heads over {cfg.num_kv_heads} kv heads x "
             f"{cfg.head_dim_}, window {cfg.sliding_window}, d_ff "
             f"{cfg.d_ff} ({cfg.mlp_for}, {cfg.norm_type}"
             + (", QKV bias" if cfg.qkv_bias else "")
             + f"), d_inner {cfg.d_inner}, " if "attn" in kinds else
             f"d_inner {cfg.d_inner}, {cfg.ssm_num_heads} SSD heads x "
             f"{cfg.ssm_head_dim}, state {cfg.ssm_state_dim}, ")
          + f"vocab {cfg.vocab_size}, {cfg.dtype}; LoRA rank "
          f"{cfg.lora.rank} on {'/'.join(cfg.lora.targets)}, bank of "
          f"{ADAPTERS}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    t_init = time.perf_counter()
    params = tf.init_params(cfg, gen, "cuda", lora_adapters=ADAPTERS)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"weights: {n_bytes / 1e9:.2f} GB random from seed 0 in "
          f"{time.perf_counter() - t_init:.1f} s")
    return cfg, params, n_bytes


class StateRowWatch:
    """Around every decode chunk of ``rt``: the REC/SSD state rows of the
    slots the chunk does not serve (unbound before the chunk) must keep
    their bits.  The comparisons are ANDed into one device flag."""

    def __init__(self, rt):
        self.rt, self.plain = rt, rt.decode
        self.layers = [layer for kind, layer in zip(rt.cfg.layer_kinds,
                                                    rt.cache)
                       if kind != "attn"]
        self.flag = torch.ones((), dtype=torch.bool, device=rt.device)
        self.rows_checked = 0
        rt.decode = self

    def __call__(self):
        idle = [sid for sid, st in enumerate(self.rt.slots.states)
                if st is None]
        rows = torch.tensor(idle, dtype=torch.long, device=self.rt.device)
        before = [{k: t.index_select(0, rows) for k, t in layer.items()}
                  for layer in self.layers] if idle else []
        out = self.plain()
        for snap, layer in zip(before, self.layers):
            for k, t in layer.items():       # bit for bit: compare bytes
                self.flag.logical_and_((t.index_select(0, rows).view(
                    torch.uint8) == snap[k].view(torch.uint8)).all())
        self.rows_checked += len(idle) if out is not None else 0
        return out

    def ok(self) -> bool:
        return bool(self.flag)


def state_bounds(cfg, params, scfg, prompt_len: int) -> Dict:
    """Least times of one decode step and one prefill dispatch of the
    breakdown on this card.  Bytes: every weight once (a tied embedding
    is the LM head, read whole; an untied one only gathered), the decode
    step's windowed K/V, and the state rows of the dispatch's rows read
    and written once.  Operations: the weight products and attention (the
    scans' elementwise work is not counted)."""
    from repro_torch.models.cache import state_bytes_per_slot
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    es = torch.empty((), dtype=cfg.torch_dtype).element_size()
    embed = params["embed"].numel()
    elems = sum(t.numel() for t in _leaves(params)) - embed
    weights = (elems + (embed if cfg.tie_embeddings else 0)) * es
    attn = cfg.layer_kinds.count("attn")
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    w = cfg.sliding_window or prompt_len + 1
    B, rows = scfg.num_slots, scfg.prefill_rows * scfg.prefill_chunk
    head = D * V
    keys = min(prompt_len + 1, w)
    n_disp = -(-prompt_len // scfg.prefill_chunk)
    pairs = sum(min(p + 1, w) for p in range(prompt_len)) / n_disp \
        * scfg.prefill_rows
    state = state_bytes_per_slot(cfg)
    out = {}
    for name, nbytes, ops in (
            ("decode_step",
             weights + attn * B * keys * K * hd * 2 * es + 2 * B * state,
             2 * B * (elems + head) + attn * 4 * hd * H * B * keys),
            ("prefill_dispatch", weights + 2 * scfg.prefill_rows * state,
             2 * rows * elems + 2 * scfg.prefill_rows * head
             + attn * 4 * hd * H * pairs)):
        b = bound(nbytes, ops, cfg.torch_dtype)
        b["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        b["ops_ms"] = ops / PEAK_OPS_PER_S[cfg.torch_dtype] * 1e3
        out[name] = b
    return out


def serve_state_model(label: str, cfg, params, scfg, work, prompts,
                      device: Dict) -> Dict:
    """The trace through the captured runtime under ``CompileGuard({decode:
    1, prefill: 1})`` with adapters by name, the unserved state rows
    watched, then on a runtime whose dispatches run eagerly: every request
    finishes with its tokens, the books balance, nothing is non-finite,
    the launch counts are exact and the eager runtime's tokens equal."""
    from repro_torch import kernels
    from repro_torch.serving import (AdapterRegistry, CompileGuard,
                                     ContinuousRuntime, replay_trace,
                                     terminal_state)
    names = [f"fn{i}" for i in range(ADAPTERS)]
    rt = ContinuousRuntime(cfg, params, scfg)
    reg = AdapterRegistry(rt, names=names)
    watch = StateRowWatch(rt)
    fn_adapter = {n: n for n in names}
    print(f"serving: {scfg.num_slots} slots, block {scfg.block_size}, "
          f"{scfg.num_blocks} pool blocks, {scfg.max_blocks_per_slot} per "
          f"slot, prefill {scfg.prefill_chunk} x {scfg.prefill_rows}, decode "
          f"chunk {scfg.decode_chunk}; trace: {len(work)} greedy requests, "
          f"prompts {min(w['prompt_len'] for w in work)}-"
          f"{max(w['prompt_len'] for w in work)} tokens, "
          f"{work[0]['output_len']} output tokens, arrivals 20 ms apart")
    torch.cuda.reset_peak_memory_stats()
    sink: Dict[int, List[int]] = {}
    with FiniteLogits() as finite, CompileGuard(
            {"decode": 1, "prefill": 1}, runtime=rt) as guard:
        kernels.reset_launches()
        t_run = time.perf_counter()
        res, _ = replay_trace(rt, work, fn_adapter, prompts=prompts,
                              prefill_group=scfg.prefill_rows,
                              token_sink=sink)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    report = guard.report()
    print(f"CompileGuard: {json.dumps(report)}")
    if report["decode_compiles"] != 1 or report["prefill_compiles"] != 1:
        fail(f"{label} dispatches captured more than once: {report}")
    states = [terminal_state(r) for r in res.requests]
    if states != ["finished"] * len(work):
        fail(f"not every {label} request finished: {states}")
    if any(len(sink[w["req_id"]]) != w["output_len"] for w in work):
        fail(f"a {label} request emitted the wrong number of tokens")
    books = rt.check_invariants(res.requests)
    if books["pool"]["live"] != 0 or books["slots_active"] != 0:
        fail(f"blocks or slots still held after the drain: {books}")
    if not finite.ok():
        fail(f"non-finite logits during the {label} replay")
    for layer in rt.cache:
        for t in layer.values():
            if not bool(torch.isfinite(t).all()):
                fail(f"non-finite entries in a {label} pool or state row")
    prefills = rt.stats["prefill_chunks"] + 2 + 1   # + warmup, capture
    steps = (rt.stats["decode_chunks"] + 2 + 1) * scfg.decode_chunk
    expected = expected_launches(cfg, prefills, steps)
    print(f"launches {launches}, expected {expected} ({prefills} prefill "
          f"dispatches, {steps} decode steps incl. warmup and the eager run "
          f"before each capture)")
    if launches != expected:
        fail(f"{label} launch counts differ from layers x dispatches x sites")

    rt_e = ContinuousRuntime(cfg, params, scfg)
    AdapterRegistry(rt_e, names=names)
    rt_e._decode = EagerDispatch(rt_e._decode)
    rt_e._prefill = EagerDispatch(rt_e._prefill)
    eager_sink: Dict[int, List[int]] = {}
    replay_trace(rt_e, work, fn_adapter, prompts=prompts,
                 prefill_group=scfg.prefill_rows, token_sink=eager_sink)
    if eager_sink != sink:
        fail(f"{label}: eager and captured runtimes emit different tokens "
             f"for {[k for k in sink if sink[k] != eager_sink.get(k)]}")
    print(f"eager runtime: {len(eager_sink)} requests, tokens equal to the "
          f"captured runtime's")
    del rt_e
    gc.collect()
    torch.cuda.empty_cache()
    m = rt.metrics.histogram
    ttft, tpot = m("ttft_s").summary(), m("tpot_s").summary()
    print(f"TTFT p50 {ttft['p50']:.3f} s, TPOT p50 {tpot['p50'] * 1e3:.2f} "
          f"ms (replay clock), replay wall {wall:.1f} s, peak memory "
          f"{peak:.2f} GB allocated on {_smi(device)}; pool high water "
          f"{rt.pool.high_water} blocks")
    return {"rt": rt, "reg": reg, "watch": watch, "sink": sink,
            "finite": finite, "guard": guard,
            "out": {"layers": cfg.num_layers, "requests": len(work),
                    "replay_wall_s": wall, "ttft_p50_s": ttft["p50"],
                    "tpot_p50_s": tpot["p50"], "peak_memory_gb": peak,
                    "launches": launches, "expected_launches": expected,
                    "compile_guard": report,
                    "pool_high_water": rt.pool.high_water,
                    "recomputed_tokens": rt.stats["recomputed_tokens"]}}


def ring_generate(label: str, cfg, params, T: int, device: Dict,
                  rows: int = RING_ROWS, new: int = RING_NEW,
                  embeds: Optional[torch.Tensor] = None) -> Dict:
    """``InferenceEngine.generate`` over ring caches on these weights:
    ``rows`` prompts of T tokens (behind ``embeds`` where given), one
    adapter a row, ``new`` greedy tokens.  The decode step is captured
    once for the batch size, every ATTN layer launches one flash prefill
    and one ring decode a step (the eager run before the capture
    included), and the tokens equal an uncaptured ``decode_one`` loop's
    from a fresh prefill of the same prompts."""
    from repro_torch import kernels
    from repro_torch.core.engine import InferenceEngine
    P = 0 if embeds is None else embeds.shape[1]
    ctx = P + T + new + 8
    eng = InferenceEngine(cfg, params, max_context=ctx)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (rows, T), generator=gen,
                            device="cuda", dtype=torch.int32)
    ai = (torch.arange(rows, device="cuda") % ADAPTERS).to(torch.int32)
    with FiniteLogits() as finite:
        kernels.reset_launches()
        t_run = time.perf_counter()
        got, cache = eng.generate(prompts, new, ai, embeds=embeds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        launches = kernels.launch_counts()
        want = eager_tokens(eng, prompts, ai, new, embeds=embeds)
    captures = eng.captures()
    expected = engine_launches(cfg, 1, new)
    print(f"{label} engine: {rows} rows x {T} prompt tokens"
          + (f" behind {P} image-prefix embeddings" if P else "")
          + f", {new} new tokens over rings of "
          f"{min(ctx, cfg.sliding_window or ctx)} slots: generate "
          f"{wall:.2f} s host wall; captures "
          f"{ {str(k): n for k, n in captures.items()} }; launches "
          f"{launches}, expected {expected}")
    if captures != {(rows, ctx): 1}:
        fail(f"{label} engine: expected one capture for batch {rows}")
    if launches != expected:
        fail(f"{label} engine launches differ from layers x calls x sites")
    if not finite.ok():
        fail(f"non-finite logits in the {label} engine run")
    if not torch.equal(got, want):
        fail(f"{label} engine: captured generate and an eager decode loop "
             f"emit different tokens")
    print(f"{label} engine: tokens of the captured generate equal to an "
          f"eager decode_one loop's")
    del eng, cache
    gc.collect()
    torch.cuda.empty_cache()
    return {"rows": rows, "prompt": T, "prefix": P, "new": new,
            "generate_wall_s": wall, "launches": launches,
            "captures": {str(k): n for k, n in captures.items()}}


def state_breakdown(label: str, run: Dict, cfg, params, device: Dict,
                    prompt_len: int) -> Dict:
    """Phase 4's breakdown round at ``prompt_len``-token prompts, each
    dispatch's host wall and device busy beside its bound."""
    rt, scfg = run["rt"], run["rt"].scfg
    bounds = state_bounds(cfg, params, scfg, prompt_len)
    res = breakdown(rt, cfg, device, prompt_len=prompt_len)
    for name, b in bounds.items():
        print(f"{label} bound, {name}: {b['bound_ms']:.2f} ms "
              f"({b['bound_by']}: {b['bytes'] / 1e9:.2f} GB -> "
              f"{b['bytes_ms']:.2f} ms, {b['ops'] / 1e12:.2f} TFLOP -> "
              f"{b['ops_ms']:.2f} ms)")
    if not run["finite"].ok():
        fail(f"non-finite logits during the {label} breakdown")
    return {"breakdown": res, "bounds": bounds}


def recurrentgemma_phase(device: Dict) -> Dict:
    from repro_torch.core.sampling import sample_with_uniform
    from repro_torch.serving import ServingConfig, replay_trace

    t0 = phase(f"phase 9: serve RecurrentGemma-9B at full width "
               f"({RGEMMA_LAYERS} of 38 layers) on the card")
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, n_bytes = state_model(RGEMMA, layers=RGEMMA_LAYERS)
    scfg = ServingConfig(**RGEMMA_SERVE)
    work, prompts = system_prompt_trace(
        cfg.vocab_size, MIXTRAL_REQUESTS, RGEMMA_PROMPT, RGEMMA_OUTPUT,
        seed=0)
    run = serve_state_model("RecurrentGemma", cfg, params, scfg, work,
                            prompts, device)
    rt, sink, out = run["rt"], run["sink"], run["out"]
    window = cfg.sliding_window
    per_req = {w["req_id"]: expected_reclaimed(
        w["prompt_len"], RGEMMA_OUTPUT, window, scfg.block_size,
        scfg.decode_chunk) for w in work}
    got = rt.stats["reclaimed_blocks"]
    print(f"reclaimed blocks: {got}, rule {sum(per_req.values())} "
          f"({json.dumps(per_req)})")
    if got <= 0 or got != sum(per_req.values()):
        fail(f"reclaimed {got} blocks, the rule gives "
             f"{sum(per_req.values())}")

    # the first RGEMMA_REPEAT prompts again, on recycled slots: their state
    # rows hold the first wave's leftovers until position 0 reads zeros
    again = [dict(w, req_id=1000 + w["req_id"], arrival=0.02 * i)
             for i, w in enumerate(work[:RGEMMA_REPEAT])]
    again_prompts = {w["req_id"]: prompts[w["req_id"] - 1000]
                     for w in again}
    leftovers = sum(int(layer["h"].abs().sum() > 0) for kind, layer in
                    zip(cfg.layer_kinds, rt.cache) if kind == "rec")
    again_sink: Dict[int, List[int]] = {}
    replay_trace(rt, again, {n: n for n in run["reg"].names()},
                 prompts=again_prompts, prefill_group=scfg.prefill_rows,
                 token_sink=again_sink)
    diff = [k for k in again_sink if again_sink[k] != sink[k - 1000]]
    if diff or len(again_sink) != RGEMMA_REPEAT:
        fail(f"second wave on recycled slots emitted other tokens: {diff}")
    watch = run["watch"]
    if not watch.ok() or watch.rows_checked == 0:
        fail(f"state rows of slots no chunk served changed "
             f"({watch.rows_checked} row-chunks checked)")
    print(f"second wave: {RGEMMA_REPEAT} first-wave prompts on recycled "
          f"slots (leftover state in {leftovers} REC layers before it), "
          f"tokens equal to the first wave's; {watch.rows_checked} "
          f"row-chunks of unserved slots kept their state bits")

    # the sampling epilogue alone at this vocabulary, greedy rows
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    B = scfg.num_slots
    logits = _randn(gen, B, cfg.vocab_size, dtype=cfg.torch_dtype)
    zf = torch.zeros(B, device="cuda")
    zi = torch.zeros(B, dtype=torch.int32, device="cuda")
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    sample_ms = device_ms(lambda: sample_with_uniform(
        logits, zf, zi, torch.ones_like(zf), zf + 0.5), 20, flush)
    del flush, logits
    print(f"sampling epilogue alone, {B} rows x vocab {cfg.vocab_size}: "
          f"{sample_ms:.3f} ms device (CUDA events, L2 flushed)")
    out.update(state_breakdown("RecurrentGemma", run, cfg, params, device,
                               RGEMMA_BREAKDOWN_PROMPT))
    out["engine"] = ring_generate("RecurrentGemma", cfg, params,
                                  RGEMMA_RING_PROMPT, device)
    out.update({"weights_gb": n_bytes / 1e9, "reclaimed_blocks": got,
                "reclaimed_rule": per_req, "second_wave": len(again_sink),
                "state_row_chunks_checked": watch.rows_checked,
                "sampling_epilogue_ms": sample_ms,
                "phase_s": time.perf_counter() - t0})
    del run, rt, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 9 ok ({out['phase_s']:.1f} s)")
    return out


def mamba_phase(device: Dict) -> Dict:
    from repro_torch.models.cache import state_bytes_per_slot
    from repro_torch.serving import ServingConfig

    t0 = phase(f"phase 10: serve Mamba2-780M at full width "
               f"({MAMBA_LAYERS} of 48 layers) on the card")
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, n_bytes = state_model(MAMBA, layers=MAMBA_LAYERS)
    scfg = ServingConfig(**MAMBA_SERVE)
    print(f"state rows: {state_bytes_per_slot(cfg) / 1e6:.1f} MB a slot")
    work, prompts = system_prompt_trace(
        cfg.vocab_size, MAMBA_SERVE["num_slots"], MAMBA_PROMPT,
        MAMBA_OUTPUT, seed=1)
    run = serve_state_model("Mamba2", cfg, params, scfg, work, prompts,
                            device)
    rt, out = run["rt"], run["out"]
    if rt.needs_kv or rt.pool.high_water != 0:
        fail(f"the attention-free stack charged pool blocks (high water "
             f"{rt.pool.high_water})")
    watch = run["watch"]
    if not watch.ok():
        fail("state rows of slots no chunk served changed")
    print(f"no pool block charged (high water 0); {watch.rows_checked} "
          f"row-chunks of unserved slots kept their state bits")
    out.update(state_breakdown("Mamba2", run, cfg, params, device,
                               MAMBA_BREAKDOWN_PROMPT))
    out["engine"] = ring_generate("Mamba2", cfg, params, MAMBA_RING_PROMPT,
                                  device)
    out.update({"weights_gb": n_bytes / 1e9,
                "state_mb_per_slot": state_bytes_per_slot(cfg) / 1e6,
                "phase_s": time.perf_counter() - t0})
    del run, rt, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 10 ok ({out['phase_s']:.1f} s)")
    return out


# ---------------------------------------------- 11-13. the rest of the zoo
def nemotron_phase(device: Dict) -> Dict:
    from repro_torch.serving import ServingConfig

    t0 = phase(f"phase 11: serve Nemotron-4-340B at full width "
               f"({NEMOTRON_LAYERS} of 96 layers) on the card")
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, n_bytes = state_model(NEMOTRON, layers=NEMOTRON_LAYERS)
    scfg = ServingConfig(**NEMOTRON_SERVE)
    work, prompts = system_prompt_trace(
        cfg.vocab_size, MIXTRAL_REQUESTS, NEMOTRON_PROMPT, NEMOTRON_OUTPUT,
        seed=2)
    run = serve_state_model("Nemotron", cfg, params, scfg, work, prompts,
                            device)
    out = run["out"]
    out.update(state_breakdown("Nemotron", run, cfg, params, device,
                               NEMOTRON_BREAKDOWN_PROMPT))
    out.update({"weights_gb": n_bytes / 1e9,
                "phase_s": time.perf_counter() - t0})
    del run, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 11 ok ({out['phase_s']:.1f} s)")
    return out


def paligemma_phase(device: Dict) -> Dict:
    from repro_torch.serving import ServingConfig

    t0 = phase("phase 12: PaliGemma-3B at full width and depth on the "
               "card: image prefix on ring caches, then text-only through "
               "the runtime")
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, n_bytes = state_model(PALIGEMMA)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    embeds = _randn(gen, PALI_ROWS, cfg.num_image_tokens, cfg.d_model,
                    dtype=cfg.torch_dtype, scale=0.02)
    out = {"engine": ring_generate("PaliGemma", cfg, params, PALI_TEXT,
                                   device, rows=PALI_ROWS, new=PALI_NEW,
                                   embeds=embeds)}
    scfg = ServingConfig(**PALI_SERVE)
    work, prompts = system_prompt_trace(
        cfg.vocab_size, MIXTRAL_REQUESTS, PALI_PROMPT, PALI_OUTPUT, seed=3)
    run = serve_state_model("PaliGemma", cfg, params, scfg, work, prompts,
                            device)
    out.update(run["out"])
    out.update({"weights_gb": n_bytes / 1e9,
                "phase_s": time.perf_counter() - t0})
    del run, params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 12 ok ({out['phase_s']:.1f} s)")
    return out


def zoo_launch_phase(arch: str, device: Dict) -> Dict:
    """The warm-function launcher on ``arch`` at full width and depth:
    every request served, one capture per batch size, exact launches;
    then a batch of its largest size against an uncaptured decode loop
    (``ring_generate``)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launcher
    from repro_torch.models import transformer as tf

    argv = ["--arch", arch] + ZOO_FLAGS
    t0 = phase(f"phase 13: launch/serve.py {' '.join(argv)} on the card")
    args = launcher.build_parser().parse_args(argv)
    cfg = get_config(arch)
    print(f"model: {cfg.name}, {cfg.num_layers} layers (no depth cut), "
          f"d_model {cfg.d_model}, {cfg.num_heads} heads over "
          f"{cfg.num_kv_heads} kv heads x {cfg.head_dim_}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab_size} "
          f"({'tied' if cfg.tie_embeddings else 'untied'}"
          f"{', QKV bias' if cfg.qkv_bias else ''}, rope theta "
          f"{cfg.rope_theta:g}), {cfg.dtype}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, "cuda", lora_adapters=args.adapters)
    n_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    with FiniteLogits() as finite:
        kernels.reset_launches()
        res = launcher.serve(cfg, params, args)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    sizes = [b for _, b in res["schedule"]]
    new, ctx = args.max_new, args.prompt_len + args.max_new + 8
    if res["served"] != args.requests or \
            res["shapes"] != [(b, new) for b in sizes]:
        fail(f"{arch}: served {res['served']} of {args.requests}, shapes "
             f"{res['shapes']}")
    if not finite.ok():
        fail(f"non-finite logits in the {arch} launcher run")
    captures = res["captures"]
    if sorted(captures) != sorted((b, ctx) for b in set(sizes)) or \
            set(captures.values()) != {1}:
        fail(f"{arch}: expected one capture per batch size "
             f"{sorted(set(sizes))}, got {captures}")
    calls = len(sizes)
    steps = calls * (new - 1) + len(captures)
    expected = engine_launches(cfg, calls, steps)
    print(f"batches {sizes}; {res['tokens']} tokens in {res['wall_s']:.2f} s "
          f"({res['tokens'] / res['wall_s']:.1f} tokens/s, host clock) on "
          f"{_smi(device)}; launches {launches}, expected {expected}")
    if launches != expected or res["launches"] != expected:
        fail(f"{arch}: launch counts differ from layers x calls x sites")
    out = {"arch": arch, "layers": cfg.num_layers,
           "weights_gb": n_bytes / 1e9, "schedule": res["schedule"],
           "tokens": res["tokens"], "wall_s": res["wall_s"],
           "launches": launches,
           "captures": {str(k): n for k, n in captures.items()}}
    out["engine"] = ring_generate(arch, cfg, params, args.prompt_len, device,
                                  rows=max(sizes), new=new)
    out["phase_s"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 13 {arch} ok ({out['phase_s']:.1f} s)")
    return out


# ------------------------------------------ 14. a LoRA function's cold start
RUNTIME_PROBE = """
import json, time
t0 = time.perf_counter()
import torch, repro_torch
import repro_torch.core.engine, repro_torch.core.sharing
import repro_torch.serverless.loading
t1 = time.perf_counter()
torch.cuda.init()
torch.empty(1, device="cuda")
torch.cuda.synchronize()
t2 = time.perf_counter()
free, total = torch.cuda.mem_get_info()
print(json.dumps({"import_s": t1 - t0, "runtime_init_s": t2 - t1,
                  "free": free, "total": total}))
"""


def _spread(xs: List[float]) -> Dict:
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "runs": list(xs)}


def _fmt(s: Dict, unit: str = "s", scale: float = 1.0) -> str:
    return (f"{s['median'] * scale:.4f} {unit} (spread "
            f"{s['min'] * scale:.4f}-{s['max'] * scale:.4f}, "
            f"{len(s['runs'])} runs)")


def _timed(fn: Callable[[], object]) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree)
               if t is not None)


def _equal_trees(a, b) -> bool:
    from repro_torch.core.lora import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x, y.to(x.device)) for x, y in zip(la, lb))


def runtime_stage() -> Dict:
    """``library_load`` and ``runtime_init``: COLD_REPEATS fresh processes
    each time the imports a function runs and then ``torch.cuda.init()``
    with a first 1-element allocation.  The device memory their CUDA context
    and first allocation take: this process's free memory before the
    probe starts against the probe's own reading after its allocation."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    runs = []
    for _ in range(COLD_REPEATS):
        free_before, _ = torch.cuda.mem_get_info()
        out = subprocess.run([sys.executable, "-c", RUNTIME_PROBE],
                             capture_output=True, text=True, env=env,
                             timeout=300, check=False)
        if out.returncode:
            fail(f"runtime probe failed ({out.returncode}): "
                 f"{out.stderr[-2000:]}")
        r = json.loads(out.stdout.strip().splitlines()[-1])
        r["context_bytes"] = free_before - r["free"]
        runs.append(r)
    res = {"library_load_s": _spread([r["import_s"] for r in runs]),
           "runtime_init_s": _spread([r["runtime_init_s"] for r in runs]),
           "context_bytes": _spread([r["context_bytes"] for r in runs])}
    print(f"library_load (import torch, repro_torch and the engine, "
          f"sharing and loading modules; first run may read a cold file "
          f"cache): {_fmt(res['library_load_s'])}")
    print(f"runtime_init (torch.cuda.init() + a first 1-element "
          f"allocation): {_fmt(res['runtime_init_s'])}; a process's "
          f"context + first allocation on the card: "
          f"{_fmt(res['context_bytes'], 'MB', 1e-6)} (the port's "
          f"counterpart of the simulator's KERNEL_BYTES, 0.50 GB)")
    return res


def kernel_stage(cfg, params) -> Dict:
    """``kernel_compile``, the port's KERNEL artifact with the kernel
    library already built: load it (dlopen; once per process), the first
    eager flash prefill of a 1-row prompt over a warm one (lazily loaded
    modules, first launches), and the eager run + capture of the ring
    decode step at batch 1 (``GraphedDispatch.capture_seconds``; the first
    engine also loads the decode kernels' modules), on COLD_REPEATS fresh
    engines."""
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.kernels import cuda_lib
    from repro_torch.serving.graphs import GraphedDispatch
    if cuda_lib.library.cache_info().currsize:
        fail("the kernel library was loaded before phase 14 timed its load")
    t_lib = _timed(cuda_lib.library)
    T = COLD["prompt_len"]
    ctx = T + COLD["max_new"] + 8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    prompt = torch.randint(0, cfg.vocab_size, (1, T), generator=gen,
                           device="cuda", dtype=torch.int32)
    ai = torch.zeros(1, dtype=torch.int32, device="cuda")
    eng = InferenceEngine(cfg, params, max_context=ctx)
    first = _timed(lambda: eng.prefill(prompt, ai))
    warm = _spread([_timed(lambda: eng.prefill(prompt, ai))
                    for _ in range(COLD_REPEATS)])
    captures = []
    for _ in range(COLD_REPEATS):
        eng = InferenceEngine(cfg, params, max_context=ctx)
        cache, step = eng.ring(1)
        logits, _ = eng.prefill(prompt, ai, cache=cache)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        pos = torch.full((), T, dtype=torch.int32, device="cuda")
        before = GraphedDispatch.capture_seconds
        step(tok, pos, ai)
        torch.cuda.synchronize()
        captures.append(GraphedDispatch.capture_seconds - before)
        del eng, cache, step
        gc.collect()
    cap = _spread(captures)
    total = t_lib + max(first - warm["median"], 0.0) + captures[0]
    res = {"library_s": t_lib, "prefill_first_s": first,
           "prefill_warm_s": warm, "capture_s": cap,
           "kernel_compile_s": total}
    print(f"kernel_compile: kernel library load {t_lib:.4f} s (once a "
          f"process); first eager flash prefill of 1 x {T} tokens "
          f"{first:.4f} s against {_fmt(warm)} warm; eager run + capture "
          f"of the batch-1 ring decode step {_fmt(cap)} (the first loads "
          f"the decode modules) -> {total:.4f} s a cold process (library + "
          f"first-launch excess + first capture)")
    torch.cuda.empty_cache()
    return res


def pcie_bound(nbytes: int) -> Dict:
    """Least time of a host-to-device copy of ``nbytes`` over the card's
    PCIe link, at its maximum generation and width as nvidia-smi reports
    them; where it reports none, the H100 SXM data sheet's Gen5 x16."""
    q = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.max,pcie.link.width.max",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=False)
    parts = [p.strip() for p in q.stdout.strip().split(",")]
    if len(parts) == 2 and all(p.isdigit() for p in parts):
        gen, width, source = int(parts[0]), int(parts[1]), "nvidia-smi"
    else:
        gen, width = 5, 16
        source = (f"nvidia-smi reports {q.stdout.strip() or 'nothing'}; "
                  f"the H100 SXM data sheet's Gen5 x16")
    coding = 0.8 if gen <= 2 else 128 / 130
    rate = PCIE_GT_S[gen] * 1e9 * width * coding / 8
    return {"gen": gen, "width": width, "source": source,
            "bytes_per_s": rate, "bound_s": nbytes / rate}


def backbone_stage(cfg, params) -> Dict:
    """``backbone_load``: the drawn backbone into one flat pinned HOST-tier
    buffer (the device-to-host copy an offload makes), then
    ``pipelined_device_put`` from it COLD_REPEATS times, and from a
    pageable copy through the staging ring COLD_REPEATS times, beside a
    per-leaf ``.to("cuda")`` from the pageable copy and the PCIe bound.
    The staging ring's overlap, in ``estimate_load_seconds``'s terms:
    its host copies alone (the same chunks into two pinned buffers, no
    DMA) h, the pinned path's DMA alone d and both together t give
    overlap = 1 - (t - max(h, d)) / min(h, d).  Every loaded leaf must
    equal its source bit for bit."""
    from repro_torch.core.lora import partition_lora, tree_leaves
    from repro_torch.serverless.latency import LatencyModel
    from repro_torch.serverless.loading import (STAGE_CHUNK_BYTES,
                                                pin_host_tier,
                                                pipelined_device_put,
                                                stage_plan)
    backbone, _ = partition_lora(params)
    nbytes = _nbytes(backbone)
    counted = LatencyModel().backbone_bytes(cfg)
    tier = pin_host_tier(backbone)
    if not _equal_trees(backbone, tier.params):
        fail("the HOST tier differs from the device tree")
    print(f"backbone: {len(tree_leaves(backbone))} leaves, "
          f"{nbytes / 1e9:.3f} GB "
          f"(LatencyModel.backbone_bytes counts {counted / 1e9:.3f} GB); "
          f"HOST tier: {tier.nbytes_pinned / 1e9:.3f} GB pinned with "
          f"cudaHostRegister in one buffer: allocate + register "
          f"{tier.register_s:.3f} s, then the copy from the card (an "
          f"offload's direction) {tier.copy_s:.3f} s "
          f"({nbytes / tier.copy_s / 1e9:.2f} GB/s)")

    def loads(tree) -> List[float]:
        secs = []
        for _ in range(COLD_REPEATS):
            got, s = pipelined_device_put(tree)
            if not _equal_trees(backbone, got):
                fail("a loaded backbone leaf differs from its source")
            secs.append(s)
            del got
        return secs

    res = {"bytes": nbytes, "backbone_bytes": counted,
           "pinned_bytes": tier.nbytes_pinned,
           "register_s": tier.register_s, "offload_copy_s": tier.copy_s,
           "pinned_load_s": _spread(loads(tier))}
    t0 = time.perf_counter()
    pageable = _map_clone(tier.params)
    res["pageable_copy_s"] = time.perf_counter() - t0
    if any(x.is_pinned() for x in tree_leaves(pageable)):
        fail("the pageable copy is pinned")
    res["staged_load_s"] = _spread(loads(pageable))

    srcs = [x.reshape(-1).view(torch.uint8) for x in tree_leaves(pageable)]
    plan = stage_plan([s.numel() for s in srcs], STAGE_CHUNK_BYTES)
    bufs = [torch.empty(STAGE_CHUNK_BYTES, dtype=torch.uint8,
                        pin_memory=True) for _ in range(2)]

    def host_copies() -> None:
        for k, pieces in enumerate(plan):
            for i, off, at, n in pieces:
                bufs[k % 2][at:at + n].copy_(srcs[i][off:off + n])

    res["host_copy_s"] = _spread([_timed(host_copies)
                                  for _ in range(COLD_REPEATS)])
    del bufs, srcs

    def per_leaf():
        got = [x.to("cuda") for x in tree_leaves(pageable)]
        torch.cuda.synchronize()
        return got

    yard = []
    for _ in range(COLD_REPEATS):
        t0 = time.perf_counter()
        got = per_leaf()
        yard.append(time.perf_counter() - t0)
        if not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(backbone), got)):
            fail("a per-leaf .to('cuda') copy differs from its source")
        del got
    res["per_leaf_to_s"] = _spread(yard)
    del pageable
    h, d = res["host_copy_s"]["median"], res["pinned_load_s"]["median"]
    t = res["staged_load_s"]["median"]
    res["overlap"] = 1.0 - (t - max(h, d)) / min(h, d)
    res["pcie"] = pcie_bound(nbytes)
    res["h2d_bw"] = nbytes / d
    print(f"backbone_load, pinned HOST tier -> card (pipelined_device_put, "
          f"one non_blocking copy a leaf on a side stream): "
          f"{_fmt(res['pinned_load_s'])}, {nbytes / d / 1e9:.2f} GB/s")
    print(f"backbone_load, pageable -> card through the staging ring "
          f"(2 x {STAGE_CHUNK_BYTES >> 20} MiB pinned, {len(plan)} chunks): "
          f"{_fmt(res['staged_load_s'])}; its host copies alone "
          f"{_fmt(res['host_copy_s'])}; overlap {res['overlap']:.3f} "
          f"(the reference assumes 0.85)")
    print(f"yardstick, per-leaf .to('cuda') from pageable memory: "
          f"{_fmt(res['per_leaf_to_s'])}")
    p = res["pcie"]
    print(f"PCIe bound: Gen{p['gen']} x{p['width']} "
          f"({p['bytes_per_s'] / 1e9:.1f} GB/s; {p['source']}): "
          f"{p['bound_s']:.4f} s for {nbytes / 1e9:.3f} GB; the stand-in "
          f"h2d_bw of 32 GB/s gives {nbytes / 32e9:.4f} s; every loaded "
          f"leaf equal to its source bit for bit")
    res["tier"] = tier
    return res


def one_adapter(params, i: int):
    """Adapter ``i`` of the stacked bank as a bank of one (leaves (L, 1,
    D, r) / (L, 1, r, O)): one function's ADAPTER artifact."""
    from repro_torch.core.lora import partition_lora
    return _tree_map(lambda x: x.narrow(-3, i, 1).contiguous(),
                     partition_lora(params)[1])


def adapter_stage(cfg, params, i: int):
    """``adapter_load``: adapter ``i`` from a pinned HOST tier to the card
    by ``pipelined_device_put``, COLD_REPEATS times, bit for bit.  Returns
    (its numbers, the last loaded tree)."""
    from repro_torch.core.lora import adapter_bytes
    from repro_torch.serverless.loading import (pin_host_tier,
                                                pipelined_device_put)
    src = one_adapter(params, i)
    tier = pin_host_tier(src)
    secs, got = [], None
    for _ in range(COLD_REPEATS):
        got, s = pipelined_device_put(tier)
        if not _equal_trees(src, got):
            fail(f"adapter {i}: a loaded leaf differs from its source")
        secs.append(s)
    res = {"adapter": i, "bytes": _nbytes(src),
           "adapter_bytes": adapter_bytes(cfg), "load_s": _spread(secs)}
    print(f"adapter_load, adapter {i} ({res['bytes'] / 1e6:.2f} MB; "
          f"adapter_bytes counts {res['adapter_bytes'] / 1e6:.2f} MB) from "
          f"pinned memory: {_fmt(res['load_s'], 'ms', 1e3)}, bit for bit")
    return res, got


def function_batch(cfg, seed: int):
    """A batch of COLD["rows"] requests for one function, formed by the
    fill-or-expire queue, and its random prompts."""
    from repro_torch.serverless.batching import (FunctionQueue, Request,
                                                 profile_function)
    from repro_torch.serverless.latency import SLICE_HW, LatencyModel
    T, rows = COLD["prompt_len"], COLD["rows"]
    q = FunctionQueue("fn", profile_function(cfg, T, 2.5,
                                             LatencyModel(SLICE_HW),
                                             mem_cap_batch=rows))
    for r in range(rows + 1):
        q.push(Request(r, "fn", 0.01 * r, T, COLD["max_new"], 2.5))
    batch = q.pop_batch()
    if len(batch) != rows:
        fail(f"the queue formed a batch of {len(batch)}, not {rows}")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (rows, T), generator=gen,
                         device="cuda", dtype=torch.int32)


def ring_bytes(eng) -> int:
    """Device bytes of an engine's rings, each tensor rounded up to the
    caching allocator's 512-byte blocks."""
    return sum(-(-t.numel() * t.element_size() // 512) * 512
               for cache, _ in eng._rings.values() for layer in cache
               for t in layer.values() if isinstance(t, torch.Tensor))


def cold_phase(device: Dict) -> Dict:
    """Phase 14 (see the module docstring)."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.core.engine import InferenceEngine
    from repro_torch.core.lora import partition_lora, tree_leaves
    from repro_torch.core.sharing import BackboneStore, FunctionInstance
    from repro_torch.serverless.latency import H100_HW
    from repro_torch.serverless.loading import pipelined_device_put
    from repro_torch.serving.graphs import GraphedDispatch

    t_phase = phase("phase 14: a LoRA function's cold start, Llama-2-7B "
                    "full width, stage by stage")
    torch.cuda.mem_get_info()          # this process's context first
    out: Dict = {"runtime": runtime_stage()}
    cfg, params = model_params()
    torch.cuda.reset_peak_memory_stats()
    out["kernel"] = kernel_stage(cfg, params)
    bb = backbone_stage(cfg, params)
    tier = bb.pop("tier")
    out["backbone"] = bb
    first, second = COLD_FNS
    ad1, ad1_dev = adapter_stage(cfg, params, first)
    out["adapter"] = ad1
    loaded, _ = pipelined_device_put(tier)
    tier.close()
    del tier

    # 5. the first function, cold: its backbone and adapter as loaded
    T, new, rows = COLD["prompt_len"], COLD["max_new"], COLD["rows"]
    ctx = T + new + 8
    store = BackboneStore()
    store.register("llama2-7b", cfg, loaded)
    fn1 = FunctionInstance(f"fn{first}", store.open("llama2-7b"), ad1_dev, 0)
    prompts = function_batch(cfg, seed=9)
    zeros = torch.zeros(rows, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    mem_e0 = torch.cuda.memory_allocated()
    eng = InferenceEngine(cfg, fn1.params, max_context=ctx)

    def first_token() -> None:
        cache, _ = eng.ring(rows)
        logits, _ = eng.prefill(prompts, zeros, cache=cache)
        torch.argmax(logits, dim=-1)

    cold_prefill = _timed(first_token)
    with FiniteLogits() as finite:
        kernels.reset_launches()
        cap0 = GraphedDispatch.capture_seconds
        got, _ = eng.generate(prompts, new, zeros)
        torch.cuda.synchronize()
        capture = GraphedDispatch.capture_seconds - cap0
        launches = kernels.launch_counts()
    # what the engine holds beside its rings (the captured step's staged
    # inputs and outputs, the streams' library workspaces)
    engine_extra = torch.cuda.memory_allocated() - mem_e0 - ring_bytes(eng)
    warm = _spread([_timed(first_token) for _ in range(COLD_REPEATS)])
    ref_eng = InferenceEngine(cfg, params, max_context=ctx)
    want, _ = ref_eng.generate(prompts, new, torch.full_like(zeros, first))
    expected = engine_launches(cfg, 1, new)
    if launches != expected:
        fail(f"cold function launches {launches}, expected {expected}")
    if not finite.ok():
        fail("non-finite logits in the cold function's batch")
    if not torch.equal(got, want):
        fail("the cold function's tokens differ from the same batch on the "
             "tree drawn on the card")
    r, k = out["runtime"], out["kernel"]
    stages = {"library_load": r["library_load_s"]["median"],
              "runtime_init": r["runtime_init_s"]["median"],
              "kernel_compile": k["kernel_compile_s"],
              "backbone_load": bb["pinned_load_s"]["median"],
              "adapter_load": ad1["load_s"]["median"],
              "prefill_first_token": cold_prefill}
    cold_ttft = sum(stages.values())
    out["cold"] = {"stages": stages, "cold_ttft_s": cold_ttft,
                   "warm_ttft_s": warm, "capture_s": capture,
                   "launches": launches}
    print(f"cold function fn{first}: {rows} x {T}-token prompts from the "
          f"fill-or-expire queue, {new} new tokens; launches {launches} = "
          f"expected; tokens equal to the same batch on the drawn tree "
          f"(adapter {first} of the bank)")
    print(f"cold TTFT {cold_ttft:.4f} s = "
          + " + ".join(f"{n} {v:.4f}" for n, v in stages.items())
          + f"; warm TTFT of the same batch {_fmt(warm)}; the batch's "
          f"decode-step capture {capture:.4f} s (not on the TTFT path) on "
          f"{_smi(device)}")

    # 6. a second function on the same backbone
    ad2_src = one_adapter(params, second)
    from repro_torch.serverless.loading import pin_host_tier
    ad2_tier = pin_host_tier(ad2_src)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    ad2, t_ad2 = pipelined_device_put(ad2_tier)
    fn2 = FunctionInstance(f"fn{second}", store.open("llama2-7b"), ad2, 0)
    eng2 = InferenceEngine(cfg, fn2.params, max_context=ctx)
    prompts2 = function_batch(cfg, seed=10)
    cap0 = GraphedDispatch.capture_seconds
    got2, _ = eng2.generate(prompts2, new, zeros)
    torch.cuda.synchronize()
    capture2 = GraphedDispatch.capture_seconds - cap0
    delta = torch.cuda.memory_allocated() - mem0
    want2, _ = ref_eng.generate(prompts2, new,
                                torch.full_like(zeros, second))
    ptrs = [[t.data_ptr() for t in tree_leaves(partition_lora(f.params)[0])]
            for f in (fn1, fn2)]
    allowed = ad1["bytes"] + ring_bytes(eng2) + max(engine_extra, 0) + \
        (1 << 20)
    if ptrs[0] != ptrs[1] or store.refcount("llama2-7b") != 2:
        fail("the second function does not read the first one's backbone")
    if delta > allowed:
        fail(f"the second function took {delta} bytes of device memory, "
             f"over its adapter + rings + the first engine's state beside "
             f"its rings + 1 MiB ({allowed})")
    if not torch.equal(got2, want2):
        fail("the second function's tokens differ from the drawn tree's")
    out["second"] = {"adapter_load_s": t_ad2, "capture_s": capture2,
                     "memory_delta_bytes": delta, "allowed_bytes": allowed,
                     "ring_bytes": ring_bytes(eng2),
                     "first_engine_extra_bytes": engine_extra}
    print(f"second function fn{second} on the same backbone: adapter load "
          f"{t_ad2 * 1e3:.3f} ms + decode-step capture {capture2:.4f} s "
          f"charged; its {len(ptrs[1])} backbone leaves share data_ptrs "
          f"with fn{first}'s; device memory +{delta / 1e6:.3f} MB, within "
          f"its adapter {ad1['bytes'] / 1e6:.3f} MB + rings "
          f"{ring_bytes(eng2) / 1e6:.3f} MB + what fn{first}'s engine held "
          f"beside its rings {engine_extra / 1e6:.3f} MB + 1 MiB; tokens "
          f"equal to the drawn tree's")

    # 7. F7: a captured engine built, dropped and collected, then rebuilt,
    # in this process; the rebuilt one's replays seen by the profiler
    del eng2
    gc.collect()
    eng3 = InferenceEngine(cfg, fn2.params, max_context=ctx)
    again, _ = eng3.generate(prompts2, new, zeros)
    if not torch.equal(again, got2):
        fail("a rebuilt engine's tokens differ from the dropped one's")
    cache, step = eng3.ring(rows)
    logits, _ = eng3.prefill(prompts2, zeros, cache=cache)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    step(tok, torch.full((), T, dtype=torch.int32, device="cuda"), zeros)

    def profile_round() -> List:
        # replays at one position rewrite the same slot: repeatable
        before = kernels.launch_counts()
        prof = profiled(lambda: [step.replay() for _ in range(8)])
        after = kernels.launch_counts()
        return [("replays", {k: after[k] - before[k] for k in after
                             if after[k] > before[k]}, prof)]

    _, (check,) = checked_rounds("rebuilt engine", profile_round)
    if not check["equal"]:
        fail("the profiler lost records of a rebuilt engine's replays")
    out["rebuild"] = check
    print("rebuilt engine: tokens equal to the dropped engine's; 8 replays "
          "profiled with every launch seen")
    out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 14 peak device memory {out['peak_memory_gb']:.2f} GB "
          f"(the drawn and the loaded 7B trees, rings, caches)")
    for f in (fn1, fn2):
        f.close()
    ad2_tier.close()
    del eng, eng3, ref_eng, store, loaded, params, cache, step
    gc.collect()
    torch.cuda.empty_cache()

    # 8. the simulator under SLICE_HW and under H100_HW from steps 1-4
    measured = dataclasses.replace(
        H100_HW, h2d_bw=bb["h2d_bw"],
        runtime_init_s=r["runtime_init_s"]["median"],
        library_load_s=r["library_load_s"]["median"],
        kernel_compile_s=k["kernel_compile_s"])
    out["h100_hw"] = dataclasses.asdict(measured)
    out["simulator"] = simulate(cfg, measured, stages)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14 ok ({out['phase_s']:.1f} s)")
    return out


def simulate(cfg, measured, stages: Dict) -> Dict:
    """The port's ``Simulator`` over ``tests/test_system.py``'s paper setup
    (4 x 7B + 4 x 13B functions, bursty, 1200 s, seed 0): the five
    policies and the NBS/NPL ablations under SLICE_HW and under
    ``measured``; then one fully cold 7B request's predicted stages (the
    NPL ablation, nothing pre-loaded) beside the measured ones.  Simulator
    outputs under measured constants: no time is gated on them."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.serverless import baselines as B
    from repro_torch.serverless.cluster import Cluster
    from repro_torch.serverless.latency import SLICE_HW
    from repro_torch.serverless.simulator import FunctionDef, Simulator
    from repro_torch.serverless.traces import TraceSpec, make_workload
    l13 = get_config("llama2_13b")
    fns = ([FunctionDef(f"fn7-{i}", "llama2-7b", cfg) for i in range(4)]
           + [FunctionDef(f"fn13-{i}", "llama2-13b", l13)
              for i in range(4)])
    wl = make_workload(
        [TraceSpec(f"fn7-{i}", "bursty", 0.02, 1200.0, 512, 48, 2.5)
         for i in range(4)]
        + [TraceSpec(f"fn13-{i}", "bursty", 0.012, 1200.0, 512, 48, 4.0)
           for i in range(4)], seed=0)
    policies = [B.SERVERLESS_LORA, B.SERVERLESS_LLM, B.INSTAINFER, B.VLLM,
                B.DLORA, B.variant_nbs(), B.variant_npl()]
    res: Dict = {}
    for label, hw in (("SLICE_HW (the reference's TPU stand-ins)",
                       SLICE_HW),
                      ("H100_HW (this run's steps 1-4)", measured)):
        rows = {}
        for pol in policies:
            cl = Cluster(1, 4, 2, hw.hbm_bytes, hw.host_mem_bytes)
            sim = Simulator(fns, pol, cluster=cl, hw=hw).run(
                copy.deepcopy(wl))
            rows[pol.name] = {
                "mean_ttft_s": sim.mean_ttft, "p99_ttft_s": sim.p99_ttft,
                "dollars": sim.dollars,
                "breakdown_totals": sim.breakdown_totals()}
            print(f"simulator output, {label}, {pol.name}: mean TTFT "
                  f"{sim.mean_ttft:.4f} s, p99 {sim.p99_ttft:.4f} s, "
                  f"${sim.dollars:.6f}; breakdown totals "
                  + json.dumps({k: round(v, 4) for k, v in
                                sim.breakdown_totals().items()}))
        one = Simulator([fns[0]], B.variant_npl(), hw=hw).run(
            [dict(req_id=0, fn_id="fn7-0", arrival=0.0,
                  prompt_len=COLD["prompt_len"],
                  output_len=COLD["max_new"], slo_ttft=2.5)])
        bd = one.requests[0].breakdown
        rows["cold_7b_breakdown"] = bd
        print(f"simulator output, {label}: one cold 7B request's stages "
              + json.dumps({k: round(v, 4) for k, v in bd.items()})
              + "; measured: " + json.dumps(
                  {k: round(v, 4) for k, v in stages.items()}))
        res[label.split()[0]] = rows
    return res


# ----------------------------------------------------------- 15. Whisper
def whisper_bounds(cfg, params, B: int, T: int, pos: int,
                   adapters: int) -> Dict:
    """Least times of one prefill call (B rows of ``encoder_seq`` frames
    and T prompt tokens) and one decode step (B rows at position ``pos``)
    on this card.  Prefill: every weight read once; operations: the
    encoder's products and attention over its frames, the cross K/V
    projections, and the decoder's products, self-attention and
    cross-attention over its T tokens (LoRA at rank r), the LM head at
    each row's last token.  Decode: the decoder's weights that a step
    reads (self-attention, cross-attention's q and o, the MLP, norms, the
    ``adapters`` adapters of the rows, the LM head; the embedding only
    gathered), each row's
    cross K/V and its ring's keys; operations: those products and both
    attentions."""
    D, F, V, S = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.encoder_seq
    H, K, hd, r = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_, \
        cfg.lora.rank
    L, E = cfg.num_layers, cfg.encoder_layers
    es = torch.empty((), dtype=cfg.torch_dtype).element_size()
    weights = sum(t.numel() for t in _leaves(params)) * es
    proj = 2 * D * H * hd + 2 * D * K * hd          # q, o; k, v
    lora = 4 * 2 * D * r                            # q/k/v/o: A and B
    enc_ops = E * (2 * S * (2 * D * H * hd + 2 * D * H * hd)
                   + 4 * S * D * F + 4 * S * S * H * hd)
    cross_kv = L * 2 * S * 2 * D * K * hd
    dec_ops = L * (2 * T * (proj + lora) + 2 * T * 2 * D * H * hd
                   + 4 * T * D * F + 4 * hd * H * T * (T + 1) / 2
                   + 4 * hd * H * T * S)
    pre_ops = B * (enc_ops + cross_kv + dec_ops + 2 * D * V)
    pre_bytes = weights + B * S * D * es            # + the frames read
    lp = params["layers"][0]
    layer = sum(t.numel() for k, v in lp.items() if k != "xattn"
                for t in _leaves(v)) - sum(
        t.numel() for t in _leaves(lp["attn"]["lora"]))
    layer += lp["xattn"]["wq"]["w"].numel() + lp["xattn"]["wo"]["w"].numel()
    dec_weights = (L * (layer + adapters * lora)
                   + params["lm_head"].numel() + B * D) * es
    kv = L * B * (2 * S + 2 * (pos + 1)) * K * hd * es
    dec_ops_step = B * (L * (2 * (proj + lora) + 2 * 2 * D * H * hd
                             + 4 * D * F + 4 * hd * H * (pos + 1 + S))
                        + 2 * D * V)
    out = {}
    for name, nbytes, ops in (("prefill_call", pre_bytes, pre_ops),
                              ("decode_step", dec_weights + kv,
                               dec_ops_step)):
        b = bound(nbytes, ops, cfg.torch_dtype)
        b["bytes_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        b["ops_ms"] = ops / PEAK_OPS_PER_S[cfg.torch_dtype] * 1e3
        out[name] = b
    out["prefill_call"]["encoder_ops"] = B * enc_ops
    out["prefill_call"]["cross_kv_ops"] = B * cross_kv
    out["decode_step"]["cross_kv_bytes"] = L * B * 2 * S * K * hd * es
    return out


def whisper_phase(device: Dict) -> Dict:
    """Whisper-medium at full width and depth through
    ``InferenceEngine.generate(frame_embeds=)``: WHISPER_ROWS rows of
    ``encoder_seq`` random frame embeddings (the reference's stub
    frontend: N(0, 1)) and WHISPER_PROMPT-token prompts, one adapter a
    row, WHISPER_NEW greedy tokens; then the first row alone, a second
    capture of the same engine.  Each run: exact launches (flash per
    encoder layer, self- and cross-attention per prefill call; ring decode
    per self- and cross-attention and SGMV per LoRA site per step), no
    non-finite logit, tokens equal to an uncaptured ``decode_one`` loop's
    from a fresh prefill; the rows' cross caches differ pairwise.  Then
    one prefill call and WHISPER_STEPS captured decode steps
    (``ring_breakdown``), beside their bounds."""
    from repro_torch import kernels
    from repro_torch.core.engine import InferenceEngine
    t0 = phase("phase 15: Whisper-medium at full width and depth on the "
               "card: encoder over 1500 frames, cross-attention, captured "
               "ring decode")
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params, n_bytes = state_model(WHISPER)
    print(f"encoder: {cfg.encoder_layers} layers over {cfg.encoder_seq} "
          f"frames (bidirectional, RoPE, GELU MLP); cross-attention in each "
          f"of the {cfg.num_layers} decoder layers; no LoRA on either")
    B, T, new, S = WHISPER_ROWS, WHISPER_PROMPT, WHISPER_NEW, \
        cfg.encoder_seq
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    frames = _randn(gen, B, S, cfg.d_model, dtype=cfg.torch_dtype)
    prompts = torch.randint(0, cfg.vocab_size, (B, T), generator=gen,
                            device="cuda", dtype=torch.int32)
    ai = (torch.arange(B, device="cuda") % ADAPTERS).to(torch.int32)
    ctx = T + new + 8
    eng = InferenceEngine(cfg, params, max_context=ctx)
    expected = engine_launches(cfg, 1, new)
    runs = {}
    with FiniteLogits() as finite:
        for rows in (B, 1):
            kernels.reset_launches()
            t_run = time.perf_counter()
            got, cache = eng.generate(prompts[:rows], new, ai[:rows],
                                      frame_embeds=frames[:rows])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_run
            launches = kernels.launch_counts()
            if rows > 1:
                for n in (0, cfg.num_layers - 1):
                    xk = cache[n]["xk"]
                    same = [(i, j) for i in range(rows)
                            for j in range(i + 1, rows)
                            if torch.equal(xk[i], xk[j])]
                    if same or not bool(xk.any()):
                        fail(f"Whisper: layer {n}'s cross caches of rows "
                             f"{same} are equal (or all zero)")
            want = eager_tokens(eng, prompts[:rows], ai[:rows], new,
                                frame_embeds=frames[:rows])
            print(f"Whisper engine: {rows} row(s) x {S} frames + {T} prompt "
                  f"tokens, {new} new tokens over {ctx}-slot rings: "
                  f"generate {wall:.2f} s host wall; launches {launches}, "
                  f"expected {expected}")
            if launches != expected:
                fail("Whisper engine launches differ from (encoder layers + "
                     "2 x decoder layers) flash per prefill, 2 x decoder "
                     "layers ring decode and 4 x decoder layers SGMV per "
                     "step")
            if not torch.equal(got, want):
                fail(f"Whisper engine, {rows} row(s): captured generate and "
                     f"an eager decode loop emit different tokens")
            print(f"Whisper engine: {rows} row(s): tokens of the captured "
                  f"generate equal to an eager decode_one loop's")
            runs[rows] = {"generate_wall_s": wall, "launches": launches,
                          "tokens": got[:, :8].tolist()}
        captures = eng.captures()
        if captures != {(B, ctx): 1, (1, ctx): 1}:
            fail(f"Whisper engine: expected one capture per batch size, got "
                 f"{captures}")
        print(f"Whisper engine: captures "
              f"{ {str(k): n for k, n in captures.items()} }; the {B} rows' "
              f"cross caches differ pairwise")

        res = ring_breakdown("Whisper", eng, prompts, ai, device,
                             WHISPER_STEPS, frame_embeds=frames)
    if not finite.ok():
        fail("non-finite logits in the Whisper runs")
    bounds = whisper_bounds(cfg, params, B, T, T + WHISPER_STEPS - 1,
                            int(ai.unique().numel()))
    for name, b in bounds.items():
        print(f"Whisper bound, {name}: {b['bound_ms']:.3f} ms "
              f"({b['bound_by']}: {b['bytes'] / 1e9:.3f} GB -> "
              f"{b['bytes_ms']:.3f} ms, {b['ops'] / 1e12:.3f} TFLOP -> "
              f"{b['ops_ms']:.3f} ms) on {_smi(device)}")
    out = {"runs": {str(k): v for k, v in runs.items()},
           "captures": {str(k): n for k, n in captures.items()},
           "breakdown": res, "bounds": bounds, "weights_gb": n_bytes / 1e9}
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 15 ok ({out['phase_s']:.1f} s)")
    return out


# ---------------------------------------------- 16. LoRA fine-tuning
def _like(template, tree):
    """A tree read by ``load_checkpoint`` (tuples where lists were saved,
    None leaves dropped) in ``template``'s structure."""
    if isinstance(template, dict):
        return {k: _like(v, None if tree is None else tree.get(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_like(v, None if tree is None else tree[i])
                              for i, v in enumerate(template))
    return None if template is None else tree


def smoke_train_on_both(arch: str, seed: int) -> Dict:
    """One LoRA step of ``arch``'s SMOKE config in float32 (one adapter,
    LoRA B drawn N(0, 0.1)) on the card and on the CPU from the same
    weights and batch: the loss, each adapter leaf's gradient (nonzero on
    both) and the updated adapters against their tolerances, and no
    kernel launched on the card."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke
    from repro_torch.core.lora import combine_lora, partition_lora, \
        tree_leaves
    from repro_torch.models import transformer as tf
    from repro_torch.training import train
    from repro_torch.training.adamw import AdamW, constant_schedule
    cfg = get_smoke(arch).with_(dtype="float32")
    gen = torch.Generator()
    gen.manual_seed(seed)
    params = tf.init_params(cfg, gen, "cpu", lora_adapters=None,
                            lora_b_scale=0.1)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    if cfg.family == "vlm":
        batch["embeds"] = (rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)) * 0.02).astype(
            np.float32)
    if cfg.family == "audio":
        batch["frame_embeds"] = rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    got = {}
    for dev in ("cpu", "cuda"):
        bb, ad = partition_lora(_to(params, dev))
        kernels.reset_launches()
        loss, _, grads = train._value_and_grad(
            cfg, ad, lambda a: combine_lora(bb, a), train.batch_to(batch, dev),
            True)
        opt = AdamW(lr=constant_schedule(SMOKE_TRAIN_LR))
        new_ad, _ = opt.update(grads, opt.init(ad), ad)
        _, _, m = train.make_lora_train_step(cfg, opt)(
            bb, ad, opt.init(ad), batch)
        got[dev] = (float(loss), [g.cpu() for g in tree_leaves(grads)],
                    [x.cpu() for x in tree_leaves(new_ad)], float(m["loss"]),
                    kernels.launch_counts())
    (l_cpu, g_cpu, a_cpu, m_cpu, _), (l_gpu, g_gpu, a_gpu, m_gpu, launched) \
        = got["cpu"], got["cuda"]
    if any(launched.values()):
        fail(f"{arch} SMOKE: the training step launched kernels {launched}")
    if abs(l_gpu - l_cpu) > 1e-5 * max(1.0, abs(l_cpu)) or \
            abs(m_gpu - m_cpu) > 1e-5 * max(1.0, abs(m_cpu)):
        fail(f"{arch} SMOKE: loss on the card {l_gpu} vs the CPU {l_cpu}")
    grad_err, ad_err, ad_excess = 0.0, 0.0, 0.0
    for gc_, gg, ac, ag in zip(g_cpu, g_gpu, a_cpu, a_gpu):
        scale = float(gc_.abs().max())
        if scale == 0 or float(gg.abs().max()) == 0:
            fail(f"{arch} SMOKE: an adapter leaf got a zero gradient")
        grad_err = max(grad_err, float((gg - gc_).abs().max()) / scale)
        # a first AdamW step moves an element by lr g / (|g| + eps) (plus
        # the same weight decay): the two devices' steps may part by no
        # more than lr |g_card - g_cpu| / (the smaller |g| + eps), at most
        # 2 lr, plus the rounding of the parameter
        same = torch.sign(gg) == torch.sign(gc_)
        low = torch.where(same, torch.minimum(gg.abs(), gc_.abs()),
                          torch.zeros_like(gg))
        allow = SMOKE_TRAIN_LR * torch.clamp(
            (gg - gc_).abs() / (low + 1e-8), max=2.0) \
            + 1e-6 * max(1.0, float(ac.abs().max()))
        diff = (ag - ac).abs()
        ad_err = max(ad_err, float(diff.max()))
        ad_excess = max(ad_excess, float((diff - allow).max()))
    if grad_err > TRAIN_GRAD_TOL:
        fail(f"{arch} SMOKE: gradients differ by {grad_err:.3e} of a leaf's "
             f"largest (tolerance {TRAIN_GRAD_TOL})")
    if ad_excess > 0:
        fail(f"{arch} SMOKE: updated adapters differ by up to {ad_err:.3e}, "
             f"more than their gradients' difference explains")
    return {"loss": l_gpu, "loss_cpu": l_cpu, "leaves": len(g_cpu),
            "grad_rel_err": grad_err, "adapter_max_abs_err": ad_err}


def refusal_cases() -> List[str]:
    """Each kernel wrapper on CUDA inputs, one of which requires grad,
    while grad mode is on: each must raise ValueError before it launches
    anything."""
    from repro_torch import kernels
    bf = dict(dtype=torch.bfloat16, device="cuda")
    i32 = dict(dtype=torch.int32, device="cuda")
    q4 = torch.randn(1, 16, 2, 64, **bf).requires_grad_()
    kv4 = torch.randn(1, 16, 2, 64, **bf)
    pool = torch.randn(2, 4, 16, 64, **bf)
    tbl = torch.tensor([[1, 2]], **i32)
    cases = {
        "flash_attention": lambda f: f(q4, kv4, kv4),
        "decode_attention": lambda f: f(
            torch.randn(1, 2, 64, **bf).requires_grad_(), kv4, kv4,
            torch.arange(16, **i32), 15),
        "paged_attention": lambda f: f(
            torch.randn(1, 2, 64, **bf).requires_grad_(), pool, pool, tbl,
            torch.tensor([20], **i32)),
        "paged_prefill": lambda f: f(
            q4, pool, pool, tbl, torch.arange(16, **i32)[None]),
        "sgmv": lambda f: f(torch.randn(4, 64, **bf),
                            torch.randn(2, 64, 16, **bf).requires_grad_(),
                            torch.randn(2, 16, 64, **bf),
                            torch.zeros(4, **i32)),
    }
    refused = []
    kernels.reset_launches()
    for name, call in cases.items():
        try:
            call(kernels.get_kernel(name))
        except ValueError as e:
            if "no backward" not in str(e):
                fail(f"{name}: refused a grad-requiring input for another "
                     f"reason: {e}")
            refused.append(name)
        else:
            fail(f"{name}: the wrapper took a grad-requiring CUDA input")
    if any(kernels.launch_counts().values()):
        fail(f"a refused call launched: {kernels.launch_counts()}")
    return refused


def _train_op_kind(e) -> str:
    """Kind of the kernels a CPU op launched in a training step: under
    ``AdamW.update``, the optimizer; ``aten::bmm`` (Llama's only batched
    products: ``attention_core``'s float32 einsums, forward and
    backward), attention einsums; ``aten::mm``/``addmm``, the bf16
    matmuls (projections, MLP, LM head, LoRA); anything else elementwise
    (norms, RoPE, mask and softmax, casts, the loss, copies)."""
    node = e
    while node is not None:
        if node.name == "AdamW.update":
            return "optimizer"
        node = node.cpu_parent
    if e.name == "aten::bmm":
        return "attention_einsum"
    if e.name in ("aten::mm", "aten::addmm"):
        return "matmul"
    return "elementwise"


def train_bound(cfg, backbone, B: int, T: int) -> Dict:
    """The least time of one LoRA step at B x T tokens: the weights'
    products 3 x 2 P N in bf16 (the forward, the remat forward and the
    input gradients; the adapters' own products and weight gradients are
    below 0.5 % of it) and ``attention_core``'s float32 einsums 4 x 4 B H
    T^2 hd per layer (QK^T and PV in the forward, again in the remat
    forward, twice in the backward), against the bytes of the inputs read
    once.  P is counted from the weights and checked against the
    config's arithmetic."""
    from repro_torch.core.lora import tree_leaves
    P = sum(x.numel() for x in tree_leaves(backbone["layers"])
            if x.dim() == 2) + backbone["lm_head"].numel()
    D, H, K, hd, F, V, L = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                            cfg.head_dim_, cfg.d_ff, cfg.vocab_size,
                            cfg.num_layers)
    P_cfg = L * (2 * D * H * hd + 2 * D * K * hd + 3 * D * F) + D * V
    if P != P_cfg:
        fail(f"weights in products: {P} counted, {P_cfg} from the config")
    N = B * T
    bf16_ops = 3 * 2 * P * N
    f32_ops = 4 * 4 * B * H * T * T * hd * L
    nbytes = sum(x.numel() * x.element_size()
                 for x in tree_leaves(backbone))
    t_ops = bf16_ops / PEAK_OPS_PER_S[torch.bfloat16] \
        + f32_ops / PEAK_OPS_PER_S[torch.float32]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"weights_in_products": P, "bf16_ops": bf16_ops,
            "f32_ops": f32_ops, "bytes": nbytes,
            "bf16_ms": bf16_ops / PEAK_OPS_PER_S[torch.bfloat16] * 1e3,
            "f32_ms": f32_ops / PEAK_OPS_PER_S[torch.float32] * 1e3,
            "bytes_ms": t_bytes * 1e3,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def serve_trained_adapter(cfg, backbone, adapters, path: Path) -> Dict:
    """The trained adapter saved with ``save_checkpoint``, read back with
    ``load_checkpoint`` bit for bit, loaded by name into an
    ``AdapterRegistry`` over a 2-slot bank on the frozen backbone (phase
    4's serving shapes) and one request served on it to completion."""
    import dataclasses
    from repro_torch.checkpoint.store import load_checkpoint, \
        save_checkpoint
    from repro_torch.core.lora import combine_lora, stack_adapters, \
        tree_leaves
    from repro_torch.serving import (AdapterRegistry, ContinuousRuntime,
                                     ServingConfig, replay_trace,
                                     terminal_state)
    t0 = time.perf_counter()
    nbytes = save_checkpoint(str(path), adapters, {"arch": cfg.name})
    loaded, meta = load_checkpoint(str(path), device="cuda")
    loaded = _like(adapters, loaded)
    save_s = time.perf_counter() - t0
    a, b = tree_leaves(adapters), tree_leaves(loaded)
    if len(a) != len(b) or not all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b)):
        fail("the adapter read back from its checkpoint differs")
    print(f"trained adapter: {nbytes / 1e6:.2f} MB saved and read back bit "
          f"for bit in {save_s:.2f} s ({len(a)} leaves, meta {meta})")
    zeros = _tree_map(torch.zeros_like, adapters)
    bank_cfg = cfg.with_(lora=dataclasses.replace(cfg.lora, num_adapters=2))
    rt = ContinuousRuntime(bank_cfg, combine_lora(backbone, stack_adapters(
        [zeros, zeros])), ServingConfig(**SERVE),
        device=backbone["embed"].device)
    reg = AdapterRegistry(rt, names=["fn0"])
    slot = reg.load("trained", loaded)
    rng = np.random.default_rng(16)
    prompt = rng.integers(0, cfg.vocab_size, 300).astype(np.int32)
    work = [dict(req_id=0, fn_id="trained", arrival=0.0,
                 prompt_len=len(prompt), output_len=OUTPUT_TOKENS,
                 slo_ttft=1e9)]
    sink: Dict[int, List[int]] = {}
    with FiniteLogits() as finite:
        res, _ = replay_trace(rt, work, {"trained": "trained"},
                              prompts={0: prompt}, token_sink=sink)
        torch.cuda.synchronize()
    state = terminal_state(res.requests[0])
    if state != "finished" or len(sink.get(0, [])) != OUTPUT_TOKENS:
        fail(f"the request on the trained adapter ended {state} with "
             f"{len(sink.get(0, []))} tokens")
    if not finite.ok():
        fail("non-finite logits serving the trained adapter")
    print(f"trained adapter served from bank slot {slot}: one request of "
          f"{len(prompt)} prompt tokens, {OUTPUT_TOKENS} tokens, finished, "
          f"finite logits")
    del rt, reg
    return {"bytes": nbytes, "save_load_s": save_s, "slot": slot,
            "tokens": sink[0][:8]}


def train_phase(device: Dict) -> Dict:
    """Phase 16 (see the module docstring)."""
    from repro_torch import kernels
    from repro_torch.configs import ARCH_IDS
    from repro_torch.core.lora import combine_lora, tree_leaves
    from repro_torch.data.pipeline import lm_batches, synthetic_corpus
    from repro_torch.launch import train as launch_train
    from repro_torch.training import train
    from repro_torch.training.adamw import AdamW, constant_schedule
    t0 = phase("phase 16: LoRA fine-tuning: SMOKE card vs CPU for every "
               "config, the kernels' refusal of autograd, Llama-2-7B at "
               "full width and depth through launch/train.py")
    gc.collect()
    torch.cuda.empty_cache()
    smoke = {}
    for i, arch in enumerate(ARCH_IDS):
        smoke[arch] = smoke_train_on_both(arch, seed=i)
    print(f"SMOKE LoRA steps ({time.perf_counter() - t0:.1f} s), card = CPU "
          f"for {len(smoke)} configs (no kernel "
          f"launched): largest loss difference "
          f"{max(abs(r['loss'] - r['loss_cpu']) for r in smoke.values()):.2e}"
          f", gradients within "
          f"{max(r['grad_rel_err'] for r in smoke.values()):.2e} of a "
          f"leaf's largest (tolerance {TRAIN_GRAD_TOL}), updated adapters "
          f"within {max(r['adapter_max_abs_err'] for r in smoke.values()):.2e}"
          f" at lr {SMOKE_TRAIN_LR}, each element within its gradient's "
          f"bound; every adapter leaf's gradient nonzero")
    refused = refusal_cases()
    print(f"autograd refused by all {len(refused)} kernel wrappers on a CUDA "
          f"input that requires grad: {refused}")

    args = launch_train.build_parser().parse_args(TRAIN_ARGS)
    t_setup = time.perf_counter()
    run = launch_train.setup(args)
    torch.cuda.synchronize()
    cfg, B, T = run.cfg, args.batch, args.seq
    bb_leaves = tree_leaves(run.backbone)
    ptrs = [x.data_ptr() for x in bb_leaves]
    copies = [x.cpu() for x in bb_leaves]
    initial = _map_clone(run.adapters)
    bb_bytes = sum(x.numel() * x.element_size() for x in bb_leaves)
    print(f"setup {time.perf_counter() - t_setup:.1f} s: backbone "
          f"{bb_bytes / 1e9:.2f} GB random from seed 0, adapters "
          f"{sum(x.numel() for x in tree_leaves(run.adapters)) / 1e6:.2f} M "
          f"parameters (B = 0), batch {B} x {T} tokens of the synthetic "
          f"corpus")

    # one step at a small rate on a batch of its own lowers that batch's loss
    batch = next(lm_batches(synthetic_corpus(
        cfg.vocab_size, launch_train.CORPUS_TOKENS, seed=3), B, T, seed=2))
    dev_batch = train.batch_to(batch, "cuda")
    opt = AdamW(lr=constant_schedule(TRAIN_SMALL_LR))
    with torch.no_grad():
        before = float(train.loss_fn(combine_lora(run.backbone, initial),
                                     cfg, dev_batch, remat=False)[0])
    stepped, _, m = train.make_lora_train_step(cfg, opt)(
        run.backbone, initial, opt.init(initial), batch)
    with torch.no_grad():
        after = float(train.loss_fn(combine_lora(run.backbone, stepped), cfg,
                                    dev_batch, remat=False)[0])
    print(f"one step at lr {TRAIN_SMALL_LR}: the batch's loss {before:.6f} "
          f"(the step's own {float(m['loss']):.6f}) -> {after:.6f} "
          f"recomputed ({time.perf_counter() - t0:.1f} s into the phase)")
    if not after < before:
        fail("one small step did not lower its batch's loss")
    del stepped

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    launch_train.train(run, args.steps)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launched = kernels.launch_counts()
    if any(launched.values()):
        fail(f"the training path launched kernels: {launched}")
    if not all(math.isfinite(x) for x in run.losses):
        fail(f"non-finite losses: {run.losses}")
    if [x.data_ptr() for x in tree_leaves(run.backbone)] != ptrs:
        fail("a backbone leaf moved")
    if any(x.grad is not None or x.requires_grad for x in bb_leaves):
        fail("a backbone leaf has a .grad or requires grad")
    if not all(torch.equal(x.cpu(), c) for x, c in zip(bb_leaves, copies)):
        fail("a backbone leaf's bits changed")
    del copies
    moved = [not torch.equal(x, y) for x, y in
             zip(tree_leaves(run.adapters), tree_leaves(initial))]
    if not all(moved):
        fail(f"{moved.count(False)} adapter leaves did not move")
    steady = run.step_s[1:]
    step_ms = statistics.median(steady) * 1e3
    tok_s = B * T / (step_ms / 1e3)
    bnd = train_bound(cfg, run.backbone, B, T)
    print(f"Llama-2-7B LoRA: {args.steps} steps, losses {run.losses[0]:.4f} "
          f"-> {run.losses[-1]:.4f}, all finite; backbone {len(bb_leaves)} "
          f"leaves: same data_ptrs, same bits, no .grad; all "
          f"{len(moved)} adapter leaves moved; kernel launches {launched}")
    print(f"step losses: {', '.join(f'{x:.4f}' for x in run.losses)}")
    print(f"step host wall (ms): "
          f"{', '.join(f'{x * 1e3:.1f}' for x in run.step_s)} on "
          f"{_smi(device)}")
    print(f"train step: median {step_ms:.1f} ms over steps 1-"
          f"{args.steps - 1} ({tok_s:.0f} tokens/s); bound "
          f"{bnd['bound_ms']:.1f} ms ({bnd['bound_by']}: "
          f"{bnd['bf16_ops'] / 1e12:.2f} TFLOP bf16 at P = "
          f"{bnd['weights_in_products'] / 1e9:.3f} G weights in products -> "
          f"{bnd['bf16_ms']:.1f} ms, {bnd['f32_ops'] / 1e12:.2f} TFLOP of "
          f"float32 attention einsums -> {bnd['f32_ms']:.1f} ms; "
          f"{bnd['bytes'] / 1e9:.2f} GB -> {bnd['bytes_ms']:.1f} ms); "
          f"{bnd['bound_ms'] / step_ms:.3f} of the bound; peak device memory "
          f"{peak / 1e9:.2f} GB ({bb_bytes / 1e9:.2f} GB of it the backbone) "
          f"on {_smi(device)}")

    prof_batch = next(run.data)
    prof = profiled(lambda: run.step_fn(run.backbone, run.adapters,
                                        run.opt_state, prof_batch),
                    by_op=_train_op_kind)
    wall = prof["profiled_wall_ms"]
    busy = prof["device_busy_ms"]
    if busy is None:
        print(f"train step under the profiler: {prof['note']}")
    else:
        by_op = prof.get("device_ms_by_op", {})
        print(f"train step under the profiler: host wall {wall:.1f} ms "
              f"against device busy {busy:.1f} ms, idle share "
              f"{1 - busy / wall:.3f}; device ms by op kind "
              f"{ {k: round(v, 2) for k, v in by_op.items()} } "
              f"(attributed {sum(by_op.values()):.1f} ms); by kernel name "
              f"{ {k: round(v, 2) for k, v in prof['device_ms_by_kind'].items()} }"
              f" (profiler dropped {prof['markers_lost']} of {2 * MARKERS} "
              f"markers) on {_smi(device)}")
        if busy > wall:
            fail("device busy above the profiled host wall")

    with tempfile.TemporaryDirectory() as tmp:
        served = serve_trained_adapter(cfg, run.backbone, run.adapters,
                                       Path(tmp) / "adapter")
    out = {"smoke": smoke, "refused": refused, "losses": run.losses,
           "step_s": run.step_s, "step_ms": step_ms, "tokens_per_s": tok_s,
           "bound": bnd, "peak_memory_bytes": peak,
           "backbone_bytes": bb_bytes, "small_lr": {
               "lr": TRAIN_SMALL_LR, "before": before, "after": after},
           "profile": prof, "served": served}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 16 ok ({out['phase_s']:.1f} s)")
    return out


# ------------------------------------------ 17. the multi-device launch layer
def dryrun_phase(device: Dict) -> Dict:
    """Phase 17a (see the module docstring): host only, no card; at the
    lowest CPU priority, since it runs beside the card's phases."""
    os.nice(19)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_world
    from repro_torch.launch.sharding import BASELINE, OPTIMIZED
    t0 = phase("phase 17a: the dry run on the host over the fake 16x16 and "
               "2x16x16 worlds (meta tensors as DTensors)")
    reports = []
    for multi in (False, True):
        with fake_world(512 if multi else 256):
            for arch, shape, opt in DRYRUN_RUNS[multi]:
                r = dryrun.run_one(arch, shape, multi_pod=multi,
                                   opts=OPTIMIZED if opt else BASELINE,
                                   tag="-opt" if opt else "", save=False,
                                   world=False)
                print(dryrun.summary_line(r), flush=True)
                by = r["memory"]["argument_bytes_by_kind"]
                want = DRYRUN_GB.get((arch, shape, multi, opt))
                if want is not None:
                    got = (round(by["params"] / 1e9, 3),
                           round(by["cache"] / 1e9, 3))
                    print(f"  {arch} {shape} {r['mesh']}: weights + cache "
                          f"{got[0]} + {got[1]} GB a device; the "
                          f"reference's specs give {want[0]} + {want[1]}")
                    if got != want:
                        fail(f"dry run {arch} {shape}: argument bytes "
                             f"{got} GB, the reference's arithmetic {want}")
                if not r["cost"]["flops"] > 0 or not r["collectives"]:
                    fail(f"dry run {arch} {shape}: no FLOPs or no "
                         f"collectives counted")
                ratio = r["cost"]["flops_over_analytic"]
                if ratio is not None:
                    print(f"  {arch} {shape} {r['mesh']}: "
                          f"{r['cost']['flops']} FLOPs a device x "
                          f"{r['n_devices']} = {ratio!r} x the hand count "
                          f"{r['cost']['flops_analytic'] * r['n_devices']}")
                    if (arch, shape) in DRYRUN_GATED and not (
                            1 - 1e-9 <= ratio <= 1 + DRYRUN_FLOPS_TOL):
                        fail(f"dry run {arch} {shape} {r['mesh']}: FLOPs "
                             f"{ratio} x the hand count (a device repeats "
                             f"work)")
                    if arch == "nemotron_4_340b":
                        print(f"  Nemotron {shape} {r['mesh']}: "
                              f"flops_over_analytic {ratio!r} (at most "
                              f"{DRYRUN_NEMOTRON_MAX}: each model rank its "
                              f"share of the attention over a ring split "
                              f"on head_dim or the sequence)")
                        if not 1 - 1e-9 <= ratio <= DRYRUN_NEMOTRON_MAX:
                            fail(f"dry run {arch} {shape} {r['mesh']}: "
                                 f"FLOPs {ratio} x the hand count (the "
                                 f"model ranks repeat the attention)")
                reports.append(r)
    print(f"phase 17a ok: {len(reports)} dry runs executed "
          f"({time.perf_counter() - t0:.1f} s)")
    return {"reports": reports, "phase_s": time.perf_counter() - t0}


def _check_arg_memory(label: str, before: int, step, cfg, kinds,
                      mesh) -> Dict:
    """The card's allocated bytes for a step's args (``memory_allocated``
    since ``before``) against the dry run's per-device argument bytes of
    the same args, on the kinds ``kinds``: each allocation is rounded up
    to the allocator's 512-byte blocks, so the card holds between the
    bytes and that plus 512 a tensor."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.sharding import BASELINE
    torch.cuda.synchronize()
    got = torch.cuda.memory_allocated() - before
    specs = dryrun.arg_specs(step, mesh, cfg, BASELINE)
    by = dryrun.argument_bytes(step, specs, mesh)
    want = sum(by[k] for k in kinds)
    parts = dryrun._categories(step)
    n = sum(1 for k in kinds for t in _leaves(parts[k])
            if isinstance(t, torch.Tensor))
    print(f"{label}: the args ({'+'.join(kinds)}) take {got} B on the card "
          f"(memory_allocated), the dry run's argument bytes {want} B "
          f"({n} tensors, at most {ALLOC_GRANULE} B of rounding each)")
    if not want <= got < want + ALLOC_GRANULE * n:
        fail(f"{label}: {got} B allocated for {want} B of arguments")
    return {"allocated": got, "argument_bytes": want, "tensors": n,
            "by_kind": by}


def sharded_bounds(cfg, params, rows: int, tokens: int, context: int,
                   decode: bool) -> Dict:
    """Least time of a prefill of ``rows`` x ``tokens`` (or of one decode
    step of ``rows`` over ``context`` slots): every weight read once, the
    K/V written (read), the products' and the attention kernels'
    operations (their ``work()``), at the card's rates."""
    from repro_torch.core.lora import tree_leaves
    from repro_torch.kernels.decode_attention.ops import work as dwork
    from repro_torch.kernels.flash_attention.ops import work as fwork
    dt, L = cfg.torch_dtype, cfg.num_layers
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    leaves = tree_leaves(params)
    w_bytes = sum(x.numel() * x.element_size() for x in leaves)
    matmul = sum(x.numel() for x in leaves if x.dim() == 2) \
        - params["embed"].numel()
    meta = dict(dtype=dt, device="meta")
    if decode:
        q = torch.empty((rows, H, hd), **meta)
        kv = torch.empty((rows, context, K, hd), **meta)
        att = dwork(q, kv, kv, torch.empty((context,), dtype=torch.int32,
                                           device="meta"),
                    torch.empty((), dtype=torch.int32, device="meta"))
        n_tok, kv_bytes = rows, 0
    else:
        q = torch.empty((rows, tokens, H, hd), **meta)
        kv = torch.empty((rows, tokens, K, hd), **meta)
        att = fwork(q, kv, kv)
        n_tok = rows * tokens
        kv_bytes = 2 * rows * tokens * K * hd * kv.element_size() * L
    ops = 2 * matmul * n_tok + L * att.flops
    nbytes = w_bytes + kv_bytes + L * att.bytes
    return bound(nbytes, ops, dt)


def _device_line(label: str, prof: Dict) -> str:
    kinds = prof.get("device_ms_by_kind") or {}
    return (f"{label}: device busy {prof.get('device_busy_ms')} ms, by kind "
            + ", ".join(f"{k} {v:.2f}" for k, v in kinds.items())
            + f" (the profiler dropped {prof.get('markers_lost')} of "
            f"{2 * MARKERS} markers)")


def sharded_steps(device: Dict, mesh) -> Dict:
    """Phase 17b: build_step's prefill and serve steps of Llama-2-7B at
    full width and depth, assembled from ``launch/specs.py``'s pieces and
    run as DTensors on the one-rank mesh (``dryrun.distributed_args`` over
    the very tensors), at a reduced batch: each against the same step on
    plain tensors."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.sharding import BASELINE
    from repro_torch.models import cache as cache_lib
    from repro_torch.models import transformer as tf
    cfg = get_config(SHARDED)
    T, B1, B2 = SHARDED_CONTEXT, SHARDED_PREFILL_ROWS, SHARDED_DECODE_ROWS
    tol = TOL[cfg.torch_dtype]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    params = tf.init_params(cfg, gen, "cuda", lora_adapters=None)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B1, T),
                                     generator=gen, device="cuda",
                                     dtype=torch.int32)}
    cache = specs.abstract_cache(cfg, B1, T, device="cuda")
    pre = specs.StepSpec("prefill_step", specs.prefill_fn(cfg),
                         (params, batch, cache))
    mem_pre = _check_arg_memory(
        f"prefill_step args, {B1} x {T} tokens", base, pre, cfg,
        ("params", "batch", "cache"), mesh)
    pre_specs = dryrun.arg_specs(pre, mesh, cfg, BASELINE)
    # the kernels at these shapes: offsets are size_t / long long in the
    # sources; flash's grid (B K, T G / 64); ring decode's clusters of C
    # CTAs over (B K) pairs, partitions of P slots, a TMA box's coordinates
    # (column, slot, row) within int32
    G2 = cfg.num_heads // cfg.num_kv_heads
    rp = cuda_lib.library().ring_decode_plan(B2, cfg.num_kv_heads, G2, T,
                                             cfg.head_dim_)
    C2, P2 = rp & 255, rp >> 8 & 255
    print(f"index arithmetic: flash grid ({B1 * cfg.num_kv_heads}, "
          f"{-(-T * cfg.num_heads // cfg.num_kv_heads // 64)}), ring decode "
          f"grid ({C2}, {B2 * cfg.num_kv_heads}) in clusters of {C2}, "
          f"{-(-T // P2)} partitions of {P2} slots; largest cache element "
          f"offset {B2 * T * cfg.num_kv_heads * cfg.head_dim_} (64-bit "
          f"offsets in csrc/flash_attn.cu)")

    def prefill_plain():
        return pre.fn(params, batch, cache)[0]

    def prefill_dt():
        # DTensors over the very tensors; the ring dicts (and their host
        # counters) are the call's own
        args = dryrun.distributed_args(pre, pre_specs, mesh)
        with implicit_replication():
            return pre.fn(*args)[0]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    want = prefill_plain()
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    cache_lib.reset_ring(cache)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = prefill_dt()
    torch.cuda.synchronize()
    wall_dt = time.perf_counter() - t0
    launches_pre = kernels.launch_counts()
    peak_pre = torch.cuda.max_memory_allocated()
    got = got.full_tensor()
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    tok_plain = want.argmax(-1)
    if not torch.equal(got.argmax(-1), tok_plain) or err > tol * scale:
        fail(f"sharded prefill: logits differ by {err:.3e} (tolerance "
             f"{tol * scale:.3e}) or the greedy tokens differ")
    cache_lib.reset_ring(cache)
    prof_pre = profiled(prefill_dt)
    b_pre = sharded_bounds(cfg, params, B1, T, T, decode=False)
    print(f"sharded prefill ({B1} x {T}): host wall {wall_dt * 1e3:.1f} ms "
          f"as DTensors, {wall_plain * 1e3:.1f} ms on plain tensors; logits "
          f"max |diff| {err:.3e} (tolerance {tol * scale:.3e}), greedy "
          f"tokens equal; launches {launches_pre}; peak device memory "
          f"{peak_pre / 1e9:.2f} GB; bound {b_pre['bound_ms']:.1f} ms "
          f"({b_pre['bound_by']})")
    print(_device_line("sharded prefill under the profiler", prof_pre))

    # decode: the prefilled ring copied into each of B2 rows, the ring
    # wrapped from position T on
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ring = specs.abstract_cache(cfg, B2, T, device="cuda")
    token = torch.empty((B2,), dtype=torch.int32, device="cuda")
    pos = torch.empty((), dtype=torch.int32, device="cuda")
    srv = specs.StepSpec("serve_step", specs.serve_fn(cfg),
                         (params, token, ring, pos))
    mem_dec = _check_arg_memory(
        f"serve_step args, {B2} rows over {T} slots", base, srv, cfg,
        ("batch", "cache"), mesh)
    srv_specs = dryrun.arg_specs(srv, mesh, cfg, BASELINE)
    first = torch.stack([tok_plain[0], torch.randint(
        0, cfg.vocab_size, (), generator=gen, device="cuda")]).to(torch.int32)

    def refill():
        for src, dst in zip(cache, ring):
            for name in ("k", "v"):
                dst[name].copy_(src[name].expand_as(dst[name]))
            dst["slot_pos"].copy_(src["slot_pos"])
            dst["idx"] = T
        token.copy_(first)

    def decode(dt: bool) -> Tuple[List[torch.Tensor], List[float]]:
        refill()
        args = dryrun.distributed_args(srv, srv_specs, mesh) if dt else \
            srv.args
        logits, walls = [], []
        for s in range(SHARDED_DECODE_STEPS):
            pos.fill_(T + s)
            t0 = time.perf_counter()
            if dt:
                with implicit_replication():
                    out = srv.fn(*args)[0].full_tensor()
            else:
                out = srv.fn(*args)[0]
            token.copy_(out.argmax(-1).to(torch.int32))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            logits.append(out)
        return logits, walls

    plain_logits, plain_walls = decode(False)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    dt_logits, dt_walls = decode(True)
    launches_dec = kernels.launch_counts()
    peak_dec = torch.cuda.max_memory_allocated()
    errs = []
    for s, (a, b) in enumerate(zip(dt_logits, plain_logits)):
        e = float((a.float() - b.float()).abs().max())
        sc = max(1.0, float(b.float().abs().max()))
        errs.append(e)
        if not torch.equal(a.argmax(-1), b.argmax(-1)) or e > tol * sc:
            fail(f"sharded decode step {s}: logits differ by {e:.3e} or the "
                 f"greedy tokens differ")
    args = dryrun.distributed_args(srv, srv_specs, mesh)

    def one_step():
        with implicit_replication():
            srv.fn(*args)

    pos.fill_(T + SHARDED_DECODE_STEPS)
    prof_dec = profiled(one_step)
    b_dec = sharded_bounds(cfg, params, B2, 1, T, decode=True)
    wall = statistics.median(dt_walls[1:])
    print(f"sharded decode ({B2} rows over {T} slots, {SHARDED_DECODE_STEPS}"
          f" steps): tokens equal to the plain steps', logits max |diff| "
          f"{max(errs):.3e}; host wall a step {wall * 1e3:.2f} ms as "
          f"DTensors (median of steps 1-{SHARDED_DECODE_STEPS - 1}), "
          f"{statistics.median(plain_walls[1:]) * 1e3:.2f} ms plain; "
          f"launches {launches_dec}; peak device memory "
          f"{peak_dec / 1e9:.2f} GB; bound {b_dec['bound_ms']:.2f} ms "
          f"({b_dec['bound_by']})")
    print(_device_line("sharded decode step under the profiler", prof_dec))
    expected = {"flash_attention": cfg.num_layers,
                "decode_attention": cfg.num_layers * SHARDED_DECODE_STEPS}
    got_l = {"flash_attention": launches_pre["flash_attention"],
             "decode_attention": launches_dec["decode_attention"]}
    print(f"phase 17 launches: {got_l}, expected {expected} (SGMV, paged: "
          f"0 — the one-adapter layout and ring caches)")
    if got_l != expected:
        fail(f"sharded steps launched {got_l}, expected {expected}")
    del args, ring, cache, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"prefill": {"host_wall_ms": wall_dt * 1e3,
                        "plain_host_wall_ms": wall_plain * 1e3,
                        "max_abs_diff": err, "peak_bytes": peak_pre,
                        "bound": b_pre, "profile": prof_pre,
                        "memory": mem_pre},
            "decode": {"host_wall_ms": [w * 1e3 for w in dt_walls],
                       "plain_host_wall_ms": [w * 1e3 for w in plain_walls],
                       "max_abs_diff": errs, "peak_bytes": peak_dec,
                       "bound": b_dec, "profile": prof_dec,
                       "memory": mem_dec},
            "launches": got_l}


def sharded_train(losses16: List[float]) -> Dict:
    """Phase 17c: the training launcher with ``--mesh 1x1`` (phase 16's
    arguments: same seed, schedule and batches) for SHARDED_TRAIN_STEPS
    steps; each loss within SHARDED_LOSS_RTOL of phase 16's."""
    from repro_torch.launch import train as launch_train
    args = launch_train.build_parser().parse_args(TRAIN_ARGS
                                                  + ["--mesh", "1x1"])
    t0 = time.perf_counter()
    run = launch_train.setup(args)
    launch_train.train(run, SHARDED_TRAIN_STEPS)
    rel = [abs(a - b) / abs(b) for a, b in zip(run.losses, losses16)]
    print(f"train --mesh 1x1: losses {[round(x, 6) for x in run.losses]}, "
          f"phase 16's {[round(x, 6) for x in losses16]}: relative "
          f"differences {[f'{x:.2e}' for x in rel]} (tolerance "
          f"{SHARDED_LOSS_RTOL}); step host wall "
          f"{[round(x * 1e3, 1) for x in run.step_s]} ms "
          f"({time.perf_counter() - t0:.1f} s with setup)")
    if len(rel) != SHARDED_TRAIN_STEPS or max(rel) > SHARDED_LOSS_RTOL:
        fail(f"train --mesh 1x1 losses {run.losses} against {losses16}")
    out = {"losses": run.losses, "phase16_losses": losses16, "rel": rel,
           "step_s": run.step_s}
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_parallel_case(mesh, flush: torch.Tensor) -> Dict:
    """Phase 17d: ``_apply_moe_parallel`` on the one-rank mesh at
    Mixtral-8x22B's width (one MoE layer, MOE_PARALLEL_ROWS x
    MOE_PARALLEL_TOKENS tokens) against ``apply_moe``'s plain path, both
    dispatches, timed."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(MIXTRAL)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    p = moe.moe_init(gen, cfg, cfg.torch_dtype, "cuda")
    x = _randn(gen, MOE_PARALLEL_ROWS, MOE_PARALLEL_TOKENS, cfg.d_model,
               dtype=cfg.torch_dtype)
    out = {}
    for dispatch in ("ragged", "capacity"):
        moe.set_dispatch(dispatch)
        moe.set_parallel_mesh(None)
        want = moe.apply_moe(p, cfg, x)
        moe.set_parallel_mesh(mesh)
        got, aux = moe._apply_moe_parallel(p, cfg, x)
        got = got.full_tensor()
        err = float((got.float() - want.float()).abs().max())
        scale = max(1.0, float(want.float().abs().max()))
        tol = TOL[cfg.torch_dtype] * scale
        ms = device_ms(lambda: moe._apply_moe_parallel(p, cfg, x), 5, flush)
        moe.set_parallel_mesh(None)
        plain_ms = device_ms(lambda: moe.apply_moe(p, cfg, x), 5, flush)
        drop = float(aux["drop_fraction"].full_tensor()) \
            if "drop_fraction" in aux else None
        print(f"_apply_moe_parallel ({dispatch}, {MOE_PARALLEL_ROWS} x "
              f"{MOE_PARALLEL_TOKENS} tokens, D {cfg.d_model}, F {cfg.d_ff}"
              f", E {cfg.num_experts}): max |diff| to apply_moe {err:.3e} "
              f"(tolerance {tol:.3e}), {ms:.2f} ms against the plain path's "
              f"{plain_ms:.2f} ms" + (f", drop_fraction {drop:.4f}"
                                      if drop is not None else ""))
        if err > tol:
            fail(f"_apply_moe_parallel {dispatch}: {err:.3e} > {tol:.3e}")
        out[dispatch] = {"max_abs_diff": err, "ms": ms, "plain_ms": plain_ms,
                         "drop_fraction": drop}
    moe.set_dispatch("ragged")
    del p, x
    torch.cuda.empty_cache()
    return out


def sharded_phase(device: Dict) -> Dict:
    """Phase 17b-d (see the module docstring): one NCCL world of one rank
    on a free localhost port, destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world, make_debug_mesh
    t0 = phase("phase 17: Llama-2-7B's sharded steps at 32768 tokens, the "
               "launcher's --mesh 1x1 and the shard-local MoE on one card")
    init_world("nccl")
    try:
        mesh = make_debug_mesh(1, 1)
        steps = sharded_steps(device, mesh)
        train_rep = sharded_train(device["phase16_losses"])
        flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                            device="cuda")
        moe_rep = moe_parallel_case(mesh, flush)
    finally:
        dist.destroy_process_group()
    print(f"phase 17 ok ({time.perf_counter() - t0:.1f} s), {_smi(device)}")
    return {"steps": steps, "train": train_rep, "moe": moe_rep,
            "phase_s": time.perf_counter() - t0}


# ------------------------------------------------------------- 18. examples
EXAMPLE_MULTILORA = dict(requests=24, adapters=ADAPTERS, max_new=16)
EXAMPLES_BUDGET_S = 90.0


def serve_continuous_example(cfg, params, device: Dict) -> Dict:
    """18a: ``examples/serve_continuous.py``'s work function, its default
    trace and serving shape, on phase 4's full-width weights."""
    from repro_torch import kernels
    from repro_torch.examples import serve_continuous as ex
    from repro_torch.serving import CompileGuard, terminal_state

    args = ex.build_parser().parse_args(["--device", "cuda"])
    adapters = [ex.rand_adapter(params, 100 + a)
                for a in range(args.adapters)]
    with FiniteLogits() as finite, CompileGuard(
            {"decode": 1, "prefill": 1}) as guard:
        kernels.reset_launches()
        t0 = time.perf_counter()
        rep = ex.run(args, cfg, params, adapters, on_runtime=guard.attach)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
    rt, res = rep.pop("runtime"), rep["result"]
    report = guard.report()
    states = [terminal_state(r) for r in res.requests]
    books = rt.check_invariants(res.requests)
    st = rep["stats"]
    prefills = st["prefill_chunks"] + 2 + 1      # + warmup's two, capture's
    steps = (st["decode_chunks"] + 2 + 1) * rt.scfg.decode_chunk
    expected = expected_launches(cfg, prefills, steps)
    h = rep["snapshot"]["histograms"]
    out = {"requests": len(res.requests), "served": rep["served"],
           "states": {s: states.count(s) for s in set(map(str, states))},
           "in_use_after_drain": rep["in_use_after_drain"],
           "shared_block_maps": st["shared_block_maps"],
           "compile_guard": report, "launches": launches,
           "expected": expected, "prefill_dispatches": prefills,
           "decode_steps": steps,
           "ttft_p50_s": h["ttft_s"]["p50"], "ttft_p95_s": h["ttft_s"]["p95"],
           "tpot_p50_s": h["tpot_s"]["p50"], "tpot_p95_s": h["tpot_s"]["p95"],
           "host_bubble_fraction": rep["snapshot"]["host_bubble_fraction"],
           "tokens_per_s": rep["tokens_per_s"], "wall_s": wall}
    print(f"18a: {out['requests']} requests, terminal states "
          f"{out['states']}, in use after drain {out['in_use_after_drain']},"
          f" shared block maps {out['shared_block_maps']}, CompileGuard "
          f"{json.dumps(report)}")
    print(f"18a launches {launches}, expected {expected} ({prefills} "
          f"prefill dispatches, {steps} decode steps incl. warmup and the "
          f"eager run before each capture, {cfg.num_layers} layers, "
          f"{len(cfg.lora.targets)} LoRA sites)")
    print(f"18a: TTFT p50/p95 {out['ttft_p50_s'] * 1e3:.2f}/"
          f"{out['ttft_p95_s'] * 1e3:.2f} ms, TPOT p50/p95 "
          f"{out['tpot_p50_s'] * 1e3:.3f}/{out['tpot_p95_s'] * 1e3:.3f} ms, "
          f"host-bubble fraction {out['host_bubble_fraction']:.4f}, "
          f"{out['tokens_per_s']:.1f} tokens/s (replay clock); wall "
          f"{wall:.1f} s on {_smi(device)}")
    if None in states:
        fail("18a: a request ended in no terminal state")
    if out["in_use_after_drain"] or books["pool"]["live"]:
        fail(f"18a: blocks still in use after the drain: {books['pool']}")
    if report["decode_compiles"] != 1 or report["prefill_compiles"] != 1:
        fail(f"18a: dispatches captured more than once: {report}")
    if out["shared_block_maps"] <= 0:
        fail("18a: no prefix block was mapped")
    if not finite.ok():
        fail("18a: non-finite logits")
    if launches != expected:
        fail("18a: launch counts differ from layers x dispatches x sites")
    del rt, rep, res
    gc.collect()
    return out


def serve_multilora_example(cfg, params, device: Dict) -> Dict:
    """18b: ``examples/serve_multilora.py``'s work function on phase 4's
    full-width weights: T0 from one measured prefill, the adaptive
    scheduler, ``InferenceEngine.generate`` per batch."""
    from repro_torch import kernels
    from repro_torch.examples import serve_multilora as ex

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    profile = torch.randint(0, cfg.vocab_size, (1, ex.PROMPT_LEN),
                            generator=gen, device="cuda", dtype=torch.int32)

    def draw_prompts(served: int, b: int) -> torch.Tensor:
        g = torch.Generator(device="cuda")
        g.manual_seed(served)
        return torch.randint(0, cfg.vocab_size, (b, ex.PROMPT_LEN),
                             generator=g, device="cuda", dtype=torch.int32)

    with FiniteLogits() as finite:
        kernels.reset_launches()
        rep = ex.run(cfg, params, profile, draw_prompts, device="cuda",
                     **EXAMPLE_MULTILORA)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
    new, L = EXAMPLE_MULTILORA["max_new"], cfg.num_layers
    sizes = [d[2] for d in rep["dispatches"]]
    captures = rep["captures"]
    calls = len(sizes) + 1                       # + the profiling prefill
    steps = len(sizes) * (new - 1) + len(captures)   # + eager before capture
    expected = engine_launches(cfg, calls, steps)
    print(f"18b: T0 {rep['t0_s'] * 1e3:.2f} ms measured (one prefill of 1 x "
          f"{ex.PROMPT_LEN} tokens); batches {sizes}; captures "
          f"{ {str(k): n for k, n in captures.items()} }; launches "
          f"{launches}, expected {expected} ({calls} prefill calls, {steps} "
          f"decode steps incl. the eager run before each capture); "
          f"{rep['tokens']} tokens in {rep['wall_s']:.2f} s on "
          f"{_smi(device)}")
    if rep["served"] != EXAMPLE_MULTILORA["requests"] or \
            any(d[3] != (d[2], new) for d in rep["dispatches"]):
        fail(f"18b: served {rep['served']} requests, shapes "
             f"{[d[3] for d in rep['dispatches']]}")
    if sorted(k[0] for k in captures) != sorted(set(sizes)) or \
            set(captures.values()) != {1}:
        fail(f"18b: expected one capture per batch size: {captures}")
    if not finite.ok():
        fail("18b: non-finite logits")
    if launches != expected:
        fail("18b: launch counts differ from layers x calls x sites")
    return {"t0_s": rep["t0_s"], "batches": sizes, "launches": launches,
            "expected": expected, "tokens": rep["tokens"],
            "wall_s": rep["wall_s"], "tokens_per_s":
            rep["tokens"] / rep["wall_s"]}


def smoke_examples(device: Dict) -> Dict:
    """18c: ``quickstart``, ``train_lora`` and ``serverless_sim`` through
    their ``main`` on the card at the reference's SMOKE sizes; their own
    asserts hold inside."""
    from repro_torch import kernels
    from repro_torch.configs import get_smoke
    from repro_torch.examples import quickstart, serverless_sim, train_lora
    out: Dict[str, Dict] = {}
    t0 = time.perf_counter()
    kernels.reset_launches()
    rep = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    # one generate of 8 tokens: a prefill call, 7 steps and the eager one
    # before the step's capture
    expected = engine_launches(get_smoke("llama2_7b"), 1, 8)
    on_cpu = quickstart.simulate()
    print(f"18c quickstart: zero-copy {rep['zero_copy']}, launches "
          f"{launches}, expected {expected}; simulator lines equal to a "
          f"CPU run: {rep['simulator'] == on_cpu} "
          f"({time.perf_counter() - t0:.1f} s)")
    if launches != expected:
        fail("18c: quickstart's launch counts differ from layers x calls x "
             "sites")
    if rep["simulator"] != on_cpu:
        fail("18c: quickstart's simulator lines differ from the CPU's")
    out["quickstart"] = {"launches": launches, "tokens": rep["tokens"],
                         "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    kernels.reset_launches()
    rep = train_lora.main(["--device", "cuda", "--out",
                           str(ROOT / "build" / "train_lora_ckpts")])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    print(f"18c train_lora: pretrain {rep['history'][0]:.4f} -> "
          f"{rep['history'][-1]:.4f}, LoRA {rep['head']:.4f} -> "
          f"{rep['tail']:.4f}, checkpoint {rep['nbytes']} B, launches "
          f"{launches} ({time.perf_counter() - t0:.1f} s)")
    if any(launches.values()):
        fail("18c: the training path launched a kernel")
    out["train_lora"] = {"history": rep["history"], "head": rep["head"],
                         "tail": rep["tail"], "nbytes": rep["nbytes"],
                         "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    rep = serverless_sim.main(["--device", "cuda"])
    print(f"18c serverless_sim: max TTFT reduction "
          f"{rep['max_ttft_reduction']:.4f}, max cost reduction "
          f"{rep['max_cost_reduction']:.4f} "
          f"({time.perf_counter() - t0:.1f} s)")
    out["serverless_sim"] = dict(rep, seconds=time.perf_counter() - t0)
    return out


def examples_phase(cfg, params, device: Dict) -> Dict:
    """Phase 18 (see the module docstring)."""
    t0 = phase("phase 18: the examples (repro_torch.examples) on the card; "
               "18a and 18b at Llama-2-7B's full width and depth")
    out = {"serve_continuous": serve_continuous_example(cfg, params, device),
           "serve_multilora": serve_multilora_example(cfg, params, device),
           "smoke": smoke_examples(device)}
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 18 ok ({out['phase_s']:.1f} s; budget "
          f"{EXAMPLES_BUDGET_S:.0f} s), {_smi(device)}")
    if out["phase_s"] > EXAMPLES_BUDGET_S:
        fail(f"phase 18 took {out['phase_s']:.1f} s, over its "
             f"{EXAMPLES_BUDGET_S:.0f} s")
    # the examples' engines and runtimes hold phase 4's weights in
    # reference cycles (a dispatch and its bound step): collect them, so
    # that ``del params`` frees the weights before the later phases
    gc.collect()
    torch.cuda.empty_cache()
    return out


def start_isolated(phase_id: str, device: Dict) -> Callable[[], Dict]:
    """``isolated``, started in the background: returns a function that
    waits for the child, prints what it printed, and returns its report
    (a host-only phase runs beside the card's phases this way).  The
    child writes to a file, so that it never waits on a full pipe."""
    tmp = tempfile.mkdtemp()
    report, log = Path(tmp) / "phase.json", Path(tmp) / "phase.log"
    with open(log, "w") as f:
        child = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--child-phase",
             phase_id, "--child-report", str(report), "--child-device",
             json.dumps(device)], stdout=f, stderr=subprocess.STDOUT)

    def wait() -> Dict:
        child.wait(timeout=900)
        print(log.read_text(), end="")
        if child.returncode:
            fail(f"phase {phase_id} failed in its child process (exit "
                 f"{child.returncode})")
        data = json.loads(report.read_text())
        shutil.rmtree(tmp, ignore_errors=True)
        return data

    return wait


# phases run in a child process each (see ``isolated``)
ISOLATED = {"8": mixtral_phase, "9": recurrentgemma_phase,
            "10": mamba_phase, "11": nemotron_phase,
            "12": paligemma_phase, "14": cold_phase,
            "15": whisper_phase, "16": train_phase,
            "17": sharded_phase, "17a": dryrun_phase,
            **{f"13-{arch}": functools.partial(zoo_launch_phase, arch)
               for arch in ZOO_LAUNCH}}


def isolated(phase_id: str, device: Dict) -> Dict:
    """Run phase ``phase_id`` in a child process of this script, with a
    CUDA context and profiler of its own, and return its report.  In one
    process, once phases 3 and 7 held the hd-256 and REC/SSD cases, the
    profiler of phase 8's breakdown lost 1-2 of 128-1040 kernel records
    (the launch cross-check failed) or crashed the process in a graph
    replay, in 4 runs of 4 on one H100; run alone, each of phases 8-10
    passed.  The child writes to this process's standard output."""
    sys.stdout.flush()
    with tempfile.TemporaryDirectory() as tmp:
        report = Path(tmp) / "phase.json"
        child = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()),
             "--child-phase", phase_id, "--child-report", str(report),
             "--child-device", json.dumps(device)],
            timeout=900, check=False)
        if child.returncode:
            fail(f"phase {phase_id} failed in its child process (exit "
                 f"{child.returncode})")
        return json.loads(report.read_text())


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", type=Path, default=None,
                    help="write every number of the run to this JSON file")
    ap.add_argument("--child-phase", choices=sorted(ISOLATED),
                    help=argparse.SUPPRESS)   # set by ``isolated`` only
    ap.add_argument("--child-report", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--child-device", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child_phase is not None:
        setup()
        out = ISOLATED[args.child_phase](json.loads(args.child_device))
        args.child_report.write_text(json.dumps(out))
        return 0
    t_start = time.perf_counter()
    device = device_phase()
    build = build_phase()
    kern = kernels_phase()
    cfg, params = model_params()
    serve = serve_phase(cfg, params, device)
    launch = launcher_phase(cfg, params, device)
    overload = overload_phase(cfg, params, device)
    examples = examples_phase(cfg, params, device)
    del params
    torch.cuda.empty_cache()
    parity = parity_phase()
    torch.cuda.empty_cache()
    # 17a on the host, at the lowest priority, beside phases 8-17 on the
    # card: alone after them it set the script's wall (127-221 s)
    dry = start_isolated("17a", device)
    mixtral = isolated("8", device)
    rgemma = isolated("9", device)
    mamba = isolated("10", device)
    nemotron = isolated("11", device)
    paligemma = isolated("12", device)
    zoo = {arch: isolated(f"13-{arch}", device) for arch in ZOO_LAUNCH}
    cold = isolated("14", device)
    whisper = isolated("15", device)
    training = isolated("16", device)
    sharded = isolated("17", dict(
        device, phase16_losses=training["losses"][:SHARDED_TRAIN_STEPS]))
    dryrun_rep = dry()
    built = "fresh" if build["fresh"] else "cached"
    print(f"kernel_compile with no built library: phase 2's nvcc build "
          f"{build['seconds']:.1f} s ({built}) + "
          f"{cold['kernel']['kernel_compile_s']:.4f} s")

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
        if name == "flash_attention":
            # the sharded ring prefill's chunks (phase 3), not on the
            # one-card path: no launch counts
            line[-1]["query_offset_cases"] = [
                {key: c.get(key) for key in (
                    "dtype", "q_offset", "shape", "max_abs_err", "ms",
                    "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "equal_to_whole", "max_abs_diff_to_whole")}
                for c in kern["cases"] if "q_offset" in c]
    if args.report is not None:
        args.report.parent.mkdir(parents=True, exist_ok=True)
        args.report.write_text(json.dumps(
            {"device": device, "build": build, "kernels": kern["cases"],
             "ring_lse_max_abs_err": kern["ring_lse_max_abs_err"],
             "serve": serve, "launcher": launch, "overload": overload,
             "examples": examples, "parity": parity, "mixtral": mixtral,
             "recurrentgemma": rgemma, "mamba2": mamba,
             "nemotron": nemotron, "paligemma": paligemma,
             "launcher_zoo": zoo, "cold_start": cold, "whisper": whisper,
             "training": training, "sharded": sharded,
             "dryrun": dryrun_rep,
             "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"all phases ok in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
