"""Request-lifecycle span recorder (port of ``repro/serving/telemetry.py``).

The parts the runtime and the replay call: the span/instant taxonomy
constants, the ``Telemetry`` recorder and ``host_bubble_fraction``.  The
Chrome-trace and metrics-JSON exporters are not ported yet.

As in the reference, recording never changes what the runtime computes:
the runtime takes the same timer readings whether or not a recorder is
attached, and the recorder only receives values.
"""
from __future__ import annotations

import dataclasses
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
