"""What the per-layer readers share: the run's context and the sums over
its spans, counters and trace.  Each metric's own reader
(``metrics/<metric>.py``) picks from these; a reader that finds nothing to
read returns None, and the metric is left out of the line.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from servebench import peaks as pk
from servebench import spec
from servebench.model import lora_sites
from servebench.tracing import (TraceData, in_spans, kernel_kind, merge,
                                overlap)


@dataclasses.dataclass
class Context:
    config: Dict[str, Any]
    shapes: Dict[str, Any]
    seconds: float
    loop: Any                      # driver.OpenLoop after the window
    stats0: Dict[str, float]       # program counters at the window's start
    stats1: Dict[str, float]       # ... and at its end
    trace: Optional[TraceData]
    peaks: Dict[str, float]
    bench_dir: Any
    host_until: float = float("inf")   # clock reading (s, window time)
    #   at which the profiler started; the host-clock readings end there
    elem_bytes: int = 2


def pct(values, q: float) -> Optional[float]:
    v = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(v, q)) if v.size else None


def spans(ctx: Context, kind: Optional[str] = None) -> List[Any]:
    """The driver's calls into the runtime that started in the window."""
    return [s for s in ctx.loop.spans
            if (kind is None or s.kind == kind) and s.kind != "sleep"
            and 0.0 <= s.t0 < ctx.seconds]


def host_spans(ctx: Context, kind: Optional[str] = None) -> List[Any]:
    """Those of them that ended before the profiler started: a profiled
    call runs slower, so the host-clock readings leave them out."""
    return [s for s in spans(ctx, kind) if s.t1 <= ctx.host_until]


def counter(ctx: Context, name: str) -> float:
    return float(ctx.stats1.get(name, 0.0) - ctx.stats0.get(name, 0.0))


# ------------------------------------------------------------ admission
def queue_waits_ms(ctx: Context) -> List[float]:
    """Due time to slot bound for each request due in the window before
    the profiler started; one not bound by the window's end counts as long
    as it waited."""
    due_by = min(ctx.seconds, ctx.host_until)
    out = []
    for rec in ctx.loop.records.values():
        if 0.0 <= rec.req.due < due_by and not rec.failed:
            t = rec.bound if rec.bound == rec.bound and rec.bound <= \
                ctx.seconds else ctx.seconds
            out.append((t - rec.req.due) * 1e3)
    return out


# ------------------------------------------------------------ model step
def decode_step_ms(ctx: Context) -> Optional[float]:
    s = host_spans(ctx, "decode")
    if not s:
        return None
    steps = len(s) * ctx.config["serving"]["decode_chunk"]
    return sum(x.t1 - x.t0 for x in s) / steps * 1e3


def prefill_need(ctx: Context, span) -> Tuple[float, int]:
    """(model operations, prompt tokens computed) that one try_admit call
    needed: each admitted prompt past its cached blocks, one logit row."""
    mf = spec.work_module(ctx.bench_dir, "model_flops")
    bs = ctx.config["serving"]["block_size"]
    ops, toks = 0.0, 0
    for _, length, shared in span.info["admitted"]:
        n = max(length - shared * bs, 1)
        ops += mf.tokens(ctx.shapes, length - n, n, 1)
        toks += n
    return ops, toks


def decode_need(ctx: Context, span) -> float:
    mf = spec.work_module(ctx.bench_dir, "model_flops")
    return sum(mf.tokens(ctx.shapes, pos, n, n)
               for pos, n in span.info["emitted"].values())


def mfu(ctx: Context, kinds: Tuple[str, ...]) -> Optional[float]:
    """Model operations the window's unprofiled calls of these kinds
    needed, over their wall time at the card's peak, in %.  No card, no
    peak: None."""
    if not ctx.peaks:
        return None
    ops, wall = 0.0, 0.0
    for s in host_spans(ctx):
        if s.kind not in kinds:
            continue
        ops += prefill_need(ctx, s)[0] if s.kind == "prefill" \
            else decode_need(ctx, s)
        wall += s.t1 - s.t0
    if wall <= 0 or ops <= 0:
        return None
    return 100.0 * ops / (wall * ctx.peaks["bf16_flops_per_s"])


def prefill_tokens_per_s(ctx: Context) -> Optional[float]:
    s = host_spans(ctx, "prefill")
    wall = sum(x.t1 - x.t0 for x in s)
    toks = sum(prefill_need(ctx, x)[1] for x in s)
    return toks / wall if wall > 0 and toks else None


# ------------------------------------------------------------ kernels
def _launch_bounds(ctx: Context, span, kernel: str) -> Tuple[float, int]:
    """(summed roofline bound in s, launches) of one kernel over the
    dispatches inside one call, from the dispatch inputs the driver
    kept."""
    m, s = ctx.shapes, ctx.config["serving"]
    a, b = span.info["taps"]
    taps = ctx.loop.taps[a:b]
    if not taps:
        return 0.0, 0
    L, es = m["num_layers"], ctx.elem_bytes
    w = spec.work_module(ctx.bench_dir, kernel)
    heads = dict(heads=m["num_heads"], kv_heads=m["num_kv_heads"],
                 head_dim=m["head_dim"], block_size=s["block_size"],
                 elem_bytes=es, window=m.get("sliding_window"))
    total, launches = 0.0, 0
    for x, tbl, ai in taps:
        if span.kind == "decode":
            steps = [(x + i, ai) for i in range(s["decode_chunk"])]
        else:
            steps = [(x, np.repeat(ai, s["prefill_chunk"]))]
        for start, idx in steps:
            if kernel == "paged_decode":
                works = [w.work(tbl, start, **heads)]
            elif kernel == "paged_prefill":
                works = [w.work(tbl, start, s["prefill_chunk"], **heads)]
            else:
                works = [w.work(idx, d_in=i, d_out=o, rank=m["lora_rank"],
                                bank=m["adapters"], elem_bytes=es)
                         for t, (i, o) in lora_sites(m).items()
                         if t in m["lora_targets"]]
            for f, nb in works:
                total += L * pk.bound_s(f, nb, ctx.peaks)
                launches += L
    return total, launches


KIND_OF = {"paged_decode": "paged_attention",
           "paged_prefill": "paged_prefill", "sgmv": "sgmv"}


def roofline(ctx: Context, kernel: str, call: str) -> Optional[float]:
    """Summed bound time over summed device time of the kernel's launches
    in the traced calls of one kind, in %.  A call whose launches the
    profiler did not all report is left out of both sums."""
    if ctx.trace is None or not ctx.trace.kernels or not ctx.loop.taps:
        return None
    ss = [x for x in spans(ctx, call)
          if ctx.trace.lo <= x.t0 and x.t1 <= ctx.trace.hi]
    idx = in_spans(ctx.trace.kernels, [(x.t0, x.t1) for x in ss])
    bound, dev = 0.0, 0.0
    for x, ks in zip(ss, idx):
        mine = [ctx.trace.kernels[i] for i in ks
                if kernel_kind(ctx.trace.kernels[i][0]) == KIND_OF[kernel]]
        b, n = _launch_bounds(ctx, x, kernel)
        if n == 0 or len(mine) != n:
            continue
        bound += b
        dev += sum(e - s for _, s, e in mine)
    if dev <= 0:
        return None
    return 100.0 * bound / dev


# ------------------------------------------------------------ device
def idle_share(ctx: Context) -> Optional[float]:
    """Share of the traced time with work pending (a slot bound or a
    request queued) in which no kernel ran, in %."""
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    lo, hi = ctx.trace.lo, ctx.trace.hi
    pend = [(max(s, lo), min(e, hi)) for s, e in ctx.loop.pending
            if e > lo and s < hi]
    total = sum(e - s for s, e in pend)
    if total <= 0:
        return None
    busy = overlap(merge([(s, e) for _, s, e in ctx.trace.kernels]),
                   merge(pend))
    return 100.0 * (1.0 - busy / total)
