"""The traced run: the profiler over the window, read into kernel intervals
and the driver's spans on one clock.

The profiler drops records at a session's ends, so each session starts and
ends with ``MARKERS`` synchronised zero-cycle spin kernels that take the
losses and are left out of every number (as ``chip_smoke.py`` does).  An
anchor range opened at a known host time maps the profiler's clock onto
the driver's.  Each call into the runtime ends in a host read of its
tokens, so every kernel it launched lies inside its range: kernels are
attributed to calls by time.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

MARKERS = 512
SPIN = "spin_kernel"


def kernel_kind(name: str) -> str:
    """Frozen copy of ``chip_smoke.py::_kernel_kind``."""
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


def merge(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted intervals covering the same time."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a: List[Tuple[float, float]],
            b: List[Tuple[float, float]]) -> float:
    """Time that two sets of disjoint, sorted intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclasses.dataclass
class TraceData:
    kernels: List[Tuple[str, float, float]]   # name, start, end (s, window
    #   clock), sorted by start
    markers_seen: int
    read_s: float
    start_s: float = 0.0
    lo: float = 0.0                # the traced part of the window (s)
    hi: float = 0.0


class Session:
    def __init__(self):
        self.prof = None
        self.anchor_host: Optional[float] = None
        self.start_s = 0.0
        self.lo = self.hi = 0.0

    @staticmethod
    def warm_up() -> None:
        """A throwaway session in set-up: the first start of the profiler
        in a process imports and registers what it needs and initialises
        the device's tracing, which takes seconds; the window's session
        then starts in a fraction of one."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            Session._markers()

    def start(self, now, lo: float, hi: float) -> None:
        """Profile from now on; ``lo`` .. ``hi`` is the part of the window
        the readers take (the driver's clock)."""
        import torch
        self.lo, self.hi = lo, hi
        from torch.profiler import ProfilerActivity, profile
        t0 = time.perf_counter()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._markers()
        self.anchor_host = now()
        with torch.profiler.record_function("servebench.anchor"):
            pass
        self.start_s = time.perf_counter() - t0

    def stop(self) -> None:
        self._markers()
        self.prof.__exit__(None, None, None)

    @staticmethod
    def _markers() -> None:
        import torch
        for _ in range(MARKERS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()

    def read(self) -> TraceData:
        """Kernels, copies and sets from the profiler's raw records (the
        parsed event tree takes minutes over a window of a million
        kernels); the driver's ranges on the device's timeline are left
        out."""
        from torch.autograd import DeviceType
        t0 = time.perf_counter()
        kernels, anchor, seen = [], None, 0
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation() or name.startswith("servebench."):
                    continue
                if SPIN in name:
                    seen += 1
                    continue
                kernels.append((name, e.start_ns(), e.end_ns()))
            elif name == "servebench.anchor":
                anchor = e.start_ns()
        if anchor is None:
            kernels = []
        else:
            off = anchor / 1e9 - self.anchor_host
            kernels = sorted(((n, s / 1e9 - off, e / 1e9 - off)
                              for n, s, e in kernels), key=lambda k: k[1])
        return TraceData(kernels, seen, time.perf_counter() - t0,
                         self.start_s, self.lo, self.hi)


def in_spans(kernels: List[Tuple[str, float, float]],
             spans: List[Tuple[float, float]]) -> List[List[int]]:
    """Indices of the kernels that start inside each span (spans sorted
    and disjoint; kernels sorted by start)."""
    import bisect
    starts = [k[1] for k in kernels]
    return [list(range(bisect.bisect_left(starts, s),
                       bisect.bisect_right(starts, e)))
            for s, e in spans]


def breakdown(trace: TraceData, host: List[Tuple[str, float, float]],
              lo: float, hi: float) -> Dict[str, List]:
    """The device operations that took most time, and the idle time by
    what the host was doing (the driver's span around the gap's middle)."""
    by_name: Dict[str, float] = {}
    busy = []
    for n, s, e in trace.kernels:
        if e <= lo or s >= hi:
            continue
        s, e = max(s, lo), min(e, hi)
        by_name[n] = by_name.get(n, 0.0) + (e - s)
        busy.append((s, e))
    gaps: Dict[str, float] = {}
    cur = lo
    for s, e in sorted(busy) + [(hi, hi)]:
        if s > cur:
            mid = 0.5 * (cur + s)
            label = "host outside runtime calls"
            for name, hs, he in host:
                if hs <= mid <= he:
                    label = name
                    break
            gaps[label] = gaps.get(label, 0.0) + (s - cur)
        cur = max(cur, e)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], v] for n, v in top],
            "idle_gaps": [[n, v] for n, v in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
