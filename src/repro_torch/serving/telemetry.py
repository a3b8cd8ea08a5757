"""Request-lifecycle span recorder (port of ``repro/serving/telemetry.py``).

The span/instant taxonomy constants, the ``Telemetry`` recorder,
``host_bubble_fraction`` and the two exporters:

* ``Telemetry.chrome_trace()`` / ``write_chrome_trace(path)`` — the
  Chrome/Perfetto trace-event JSON (an object with a ``traceEvents`` array
  of ``ph: "X"`` complete spans and ``ph: "i"`` instants; one ``tid`` per
  track, named via ``ph: "M"`` metadata).  Open it at
  https://ui.perfetto.dev or chrome://tracing.
* ``write_metrics_json(snapshot, path)`` — a
  ``runtime.metrics_snapshot()`` payload, pretty-printed.

As in the reference, recording never changes what the runtime computes:
the runtime takes the same timer readings whether or not a recorder is
attached, and the recorder only receives values.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Tuple

SPAN_QUEUED = "queued"
SPAN_PREFILL = "prefill"
SPAN_DECODE = "decode"
SPAN_HOST_PLAN = "host_plan"
SPAN_DEVICE_EXECUTE = "device_execute"
SPAN_REQUEUED = "requeued"
EVT_FINISH = "finish"
EVT_ABANDON = "abandon"
EVT_REJECT = "reject"
EVT_ABORT = "abort"
EVT_STALL = "stall"
EVT_PREEMPT = "preempt"
EVT_RESUME = "resume"
TRACK_QUEUE = "queue"
TRACK_HOST = "host"
TRACK_HOST_WALL = "host-wall"
ARG_SAMPLING_MODE = "sampling_mode"


@dataclasses.dataclass
class Span:
    """One closed interval on a named track (virtual-clock seconds)."""
    name: str
    track: str
    t0: float
    t1: float
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Instant:
    """One point event on a named track (virtual-clock seconds)."""
    name: str
    track: str
    t: float
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class DispatchRecord:
    """One device dispatch in REAL wall time: [t0, t1] brackets the step
    *including* the host-blocking read of its results, so t1 - t0 is
    device-execute time and the gap to the previous record is host
    planning."""
    kind: str                    # "prefill" | "decode"
    wall_t0: float
    wall_t1: float
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Telemetry:
    """Span recorder.  Construct one and pass it to ``replay_trace`` (or
    set ``runtime.telemetry``)."""

    def __init__(self) -> None:
        self.spans: List[Span] = []
        self.instants: List[Instant] = []
        self.dispatches: List[DispatchRecord] = []

    def span(self, name: str, track: str, t0: float, t1: float,
             **args: Any) -> None:
        self.spans.append(Span(name, track, t0, t1, args))

    def instant(self, name: str, track: str, t: float, **args: Any) -> None:
        self.instants.append(Instant(name, track, t, args))

    def record_dispatch(self, kind: str, wall_t0: float, wall_t1: float,
                        **args: Any) -> None:
        self.dispatches.append(DispatchRecord(kind, wall_t0, wall_t1, args))

    def host_bubble_fraction(self) -> float:
        return host_bubble_fraction(
            [(d.wall_t0, d.wall_t1) for d in self.dispatches])

    def span_sequence(self) -> List[Tuple[str, str]]:
        """(name, track) pairs in emission order — the determinism probe:
        same trace + seed must yield the identical sequence regardless of
        measured timings (timestamps may differ; structure may not)."""
        return [(s.name, s.track) for s in self.spans] + \
               [(e.name, e.track) for e in self.instants]

    # ------------------------------------------------------------- export
    def _tracks(self) -> List[str]:
        """Stable track order: queue, host, slots by index, host-wall."""
        seen = {s.track for s in self.spans} | \
               {e.track for e in self.instants}
        slots = sorted((t for t in seen if t.startswith("slot")),
                       key=lambda t: int(t[4:]))
        fixed = [t for t in (TRACK_QUEUE, TRACK_HOST) if t in seen]
        rest = sorted(seen - set(slots) - set(fixed))
        out = fixed + slots + rest
        if self.dispatches:
            out.append(TRACK_HOST_WALL)
        return out

    def _wall_events(self, tid: int) -> List[Dict[str, Any]]:
        """host-wall track: alternate host_plan / device_execute complete
        spans in wall time, rebased so the first dispatch starts at 0."""
        evs: List[Dict[str, Any]] = []
        if not self.dispatches:
            return evs
        base = self.dispatches[0].wall_t0
        prev_end = None
        for d in self.dispatches:
            if prev_end is not None and d.wall_t0 > prev_end:
                evs.append({"name": SPAN_HOST_PLAN, "cat": "host",
                            "ph": "X", "pid": 0, "tid": tid,
                            "ts": (prev_end - base) * 1e6,
                            "dur": (d.wall_t0 - prev_end) * 1e6,
                            "args": {}})
            evs.append({"name": f"{SPAN_DEVICE_EXECUTE}:{d.kind}",
                        "cat": "device", "ph": "X", "pid": 0, "tid": tid,
                        "ts": (d.wall_t0 - base) * 1e6,
                        "dur": (d.wall_t1 - d.wall_t0) * 1e6,
                        "args": dict(d.args)})
            prev_end = max(prev_end or d.wall_t1, d.wall_t1)
        return evs

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON: ``{"traceEvents": [...]}``.

        Virtual-clock spans/instants land on their own tracks (``tid`` per
        track, seconds converted to the format's microseconds); the
        wall-clock host-plan/device-execute alternation gets the final
        track.  Events are sorted by ``ts`` within each track, so ``ts``
        is monotone per ``tid`` (asserted in tests)."""
        tracks = self._tracks()
        tid = {t: i for i, t in enumerate(tracks)}
        events: List[Dict[str, Any]] = []
        for t in tracks:
            events.append({"name": "thread_name", "ph": "M", "pid": 0,
                           "tid": tid[t], "args": {"name": t}})
        per_track: Dict[str, List[Dict[str, Any]]] = {t: [] for t in tracks}
        for s in self.spans:
            per_track[s.track].append(
                {"name": s.name, "cat": "virtual", "ph": "X", "pid": 0,
                 "tid": tid[s.track], "ts": s.t0 * 1e6,
                 "dur": (s.t1 - s.t0) * 1e6, "args": dict(s.args)})
        for e in self.instants:
            per_track[e.track].append(
                {"name": e.name, "cat": "virtual", "ph": "i", "s": "t",
                 "pid": 0, "tid": tid[e.track], "ts": e.t * 1e6,
                 "args": dict(e.args)})
        if TRACK_HOST_WALL in tid:
            per_track[TRACK_HOST_WALL] = self._wall_events(
                tid[TRACK_HOST_WALL])
        for t in tracks:
            events.extend(sorted(per_track[t], key=lambda e: e["ts"]))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)


def host_bubble_fraction(windows: List[Tuple[float, float]]) -> float:
    """Bubble fraction over [t0, t1] device-busy windows: the share of
    the first-start..last-end wall interval NOT covered by device work.
    Overlap-safe (windows are merged first) and clamped to [0, 1]."""
    if len(windows) < 2:
        return 0.0
    windows = sorted(windows)
    span0, span1 = windows[0][0], max(t1 for _, t1 in windows)
    total = span1 - span0
    if total <= 0.0:
        return 0.0
    busy, cur0, cur1 = 0.0, windows[0][0], windows[0][1]
    for t0, t1 in windows[1:]:
        if t0 > cur1:
            busy += cur1 - cur0
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
    busy += cur1 - cur0
    return min(max(1.0 - busy / total, 0.0), 1.0)


def write_metrics_json(snapshot: Dict[str, Any], path: str) -> None:
    """Dump a ``runtime.metrics_snapshot()`` payload (or any JSON-able
    metrics dict) to disk, pretty-printed for diffability."""
    with open(path, "w") as f:
        json.dump(snapshot, f, indent=2, sort_keys=True)
        f.write("\n")
