"""Typed metrics registry for the serving runtime.

Replaces (and supersets) the runtime's ad-hoc ``stats`` int-dict with
three first-class metric kinds:

* **Counter** — a monotonically-growing int (``prefill_chunks``,
  ``decode_chunks``, ``stall_steps``, ...).  The legacy ``runtime.stats``
  keys all live here; ``CounterView`` re-exposes them with the exact old
  dict interface (``stats["x"] += 1``) so nothing downstream breaks.
* **Gauge** — a sampled instantaneous value (pool occupancy, slot
  utilization, prefix-trie size).  Every ``set`` records into running
  min/max/mean so a snapshot shows the trajectory, not just the last
  sample.
* **Histogram** — raw observations with percentile summaries (p50/p95/
  p99) for the latency distributions the paper's figures are built from
  (TTFT, TPOT, per-dispatch device time).

``MetricsRegistry.snapshot()`` returns one flat JSON-able dict — the
payload ``benchmarks`` write as ``BENCH_serving.json`` and
``examples/serve_continuous.py --metrics-out`` dumps to disk.  All
metric units are encoded in the name suffix (``_s`` seconds, ``_blocks``,
``_tokens``, ``_frac`` a [0, 1] fraction) — see docs/observability.md
for the full catalog.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import MutableMapping
from typing import Dict, Iterator, List, Optional


@dataclasses.dataclass
class Counter:
    """Monotone event count.  ``value`` is plain int state — the legacy
    ``stats`` dict wrote these directly, so ``CounterView`` still can."""
    name: str
    help: str = ""
    value: int = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


@dataclasses.dataclass
class Gauge:
    """Sampled instantaneous value with running extrema/mean.

    ``set`` is the sampling point; ``last`` is what a plain gauge would
    report, ``min``/``max``/``mean`` summarize every sample taken so a
    snapshot shows e.g. both the final AND the peak pool occupancy."""
    name: str
    help: str = ""
    last: float = 0.0
    min: float = math.inf
    max: float = -math.inf
    total: float = 0.0
    count: int = 0

    def set(self, v: float) -> None:
        v = float(v)
        self.last = v
        self.min = v if v < self.min else self.min
        self.max = v if v > self.max else self.max
        self.total += v
        self.count += 1

    def summary(self) -> Dict[str, float]:
        if not self.count:
            return {"last": 0.0, "min": 0.0, "max": 0.0, "mean": 0.0,
                    "samples": 0}
        return {"last": self.last, "min": self.min, "max": self.max,
                "mean": self.total / self.count, "samples": self.count}


def percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank-with-interpolation percentile over a pre-sorted list
    (numpy's default 'linear' method, without pulling numpy into the hot
    path for every snapshot)."""
    if not sorted_vals:
        return 0.0
    if len(sorted_vals) == 1:
        return sorted_vals[0]
    pos = q * (len(sorted_vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = pos - lo
    return sorted_vals[lo] * (1.0 - frac) + sorted_vals[hi] * frac


@dataclasses.dataclass
class Histogram:
    """Latency distribution: raw observations + percentile summary.

    Observations are kept verbatim (replayed traces are thousands of
    requests, not millions — exactness beats reservoir sampling at this
    scale); ``max_samples`` caps pathological runs by dropping the OLDEST
    half when hit, which keeps recent behaviour representative."""
    name: str
    help: str = ""
    max_samples: int = 200_000
    samples: List[float] = dataclasses.field(default_factory=list)

    def observe(self, v: float) -> None:
        self.samples.append(float(v))
        if len(self.samples) > self.max_samples:
            del self.samples[: len(self.samples) // 2]

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p95": 0.0, "p99": 0.0}
        s = sorted(self.samples)
        return {"count": len(s), "mean": sum(s) / len(s),
                "min": s[0], "max": s[-1],
                "p50": percentile(s, 0.50), "p95": percentile(s, 0.95),
                "p99": percentile(s, 0.99)}


class CounterView(MutableMapping):
    """The legacy ``runtime.stats`` interface over registry counters.

    Every read/write goes straight to the ``Counter`` objects, so
    ``stats["prefill_chunks"] += 1`` and ``registry.counter(...)`` are the
    same state — old callers keep working, new callers get typed metrics.
    Writing a key that was never registered creates the counter (the old
    dict allowed ad-hoc keys; tests rely on iteration seeing them)."""

    def __init__(self, registry: "MetricsRegistry"):
        self._reg = registry

    def __getitem__(self, name: str) -> int:
        c = self._reg.counters.get(name)
        if c is None:
            raise KeyError(name)
        return c.value

    def __setitem__(self, name: str, value: int) -> None:
        self._reg.counter(name).value = int(value)

    def __delitem__(self, name: str) -> None:
        del self._reg.counters[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._reg.counters)

    def __len__(self) -> int:
        return len(self._reg.counters)

    def __repr__(self) -> str:
        return repr({k: c.value for k, c in self._reg.counters.items()})


class MetricsRegistry:
    """Name-keyed home for every serving metric.

    ``counter``/``gauge``/``histogram`` are get-or-create (idempotent, so
    call sites don't need registration ceremony); ``snapshot`` emits one
    flat JSON-able dict.  A registry is always cheap to keep around —
    counters are int adds and gauges are only written at explicit
    sampling points — so the runtime owns one unconditionally; only the
    span recorder (``telemetry.Telemetry``) is optional.
    """

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    # ------------------------------------------------------ get-or-create
    def counter(self, name: str, help: str = "") -> Counter:
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter(name, help)
        return c

    def gauge(self, name: str, help: str = "") -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge(name, help)
        return g

    def histogram(self, name: str, help: str = "",
                  max_samples: Optional[int] = None) -> Histogram:
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram(name, help)
            if max_samples is not None:
                h.max_samples = max_samples
        return h

    def counter_view(self) -> CounterView:
        return CounterView(self)

    # ----------------------------------------------------------- snapshot
    def snapshot(self) -> Dict:
        """Flat JSON-able state: every counter value, gauge summary, and
        histogram percentile block, keyed by metric name."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.summary() for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }
