"""Deterministic fault injection for the serving replay (port of
``repro/serving/faults.py``; pure host code, no device work).

Three failure modes the runtime must degrade gracefully under, keyed to
the replay's virtual clock so every chaos scenario is a regression test:

* ``ArtifactFault`` — the next ``fails`` load attempts for a matching
  adapter artifact raise ``ArtifactLoadError``.  Exercises the
  retry-with-backoff path in ``AdapterRegistry.load``/``swap``.
* ``PoolSqueeze`` — while the virtual clock is inside ``[t0, t1)`` the
  plan holds ``blocks`` pool blocks hostage (allocated through the normal
  ``BlockPool.alloc`` path, so cached prefix blocks can be evicted).
  Released when the window closes or at ``FaultPlan.finish``.
* ``DispatchSlowdown`` — measured dispatch times for ``kind`` dispatches
  inside ``[t0, t1)`` are scaled by ``factor`` *on the virtual clock
  only*: the device result is untouched, so tokens stay bitwise identical
  while every latency metric feels the slowdown.

A plan never touches the device, and an **empty plan is a no-op**: every
hook degenerates to a branch on an empty list, and the replay is
token-bitwise identical to running without one.  The adapter loader
and ``checkpoint/store.py::load_checkpoint`` (through its ``fault_hook``)
consult the plan.

``retry_with_backoff`` is the one retry primitive the artifact loaders
share — bounded attempts, exponential backoff, injectable sleep so tests
never wait on a real clock.
"""
from __future__ import annotations

import dataclasses
import time
from fnmatch import fnmatch
from typing import Any, Callable, Dict, List, Optional, Tuple


class ArtifactLoadError(RuntimeError):
    """A (possibly injected) failure while loading an adapter/checkpoint
    artifact.  Transient by contract: retrying the same load may succeed,
    which is exactly what ``retry_with_backoff`` does."""


def retry_with_backoff(fn: Callable[[], Any], *, retries: int = 2,
                       backoff_s: float = 0.0,
                       sleep: Callable[[float], None] = time.sleep,
                       on_retry: Optional[Callable[[int, BaseException],
                                                   None]] = None,
                       exceptions: Tuple[type, ...] = (ArtifactLoadError,
                                                       OSError)) -> Any:
    """Call ``fn`` with up to ``retries`` retries on transient errors.

    Backoff doubles per attempt (``backoff_s * 2**attempt``); ``sleep`` is
    injectable so tests never block, and ``on_retry(attempt, exc)`` lets
    callers count retries in their metrics.  The final failure re-raises
    unmodified — bounded retries, never an infinite loop."""
    if retries < 0:
        raise ValueError("retries must be >= 0")
    attempt = 0
    while True:
        try:
            return fn()
        except exceptions as e:
            if attempt >= retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff_s > 0.0:
                sleep(backoff_s * (2.0 ** attempt))
            attempt += 1


@dataclasses.dataclass
class ArtifactFault:
    """Fail the next ``fails`` load attempts of a matching artifact.

    ``target`` is ``"adapter"`` or ``"checkpoint"``; ``name`` is an
    fnmatch pattern over the adapter name / checkpoint path.  Consecutive
    -failure semantics: a loader with ``retries >= fails`` recovers, one
    with fewer exhausts its budget and surfaces the error."""
    target: str
    name: str = "*"
    fails: int = 1
    injected: int = 0            # attempts actually failed (report field)

    def remaining(self) -> int:
        return self.fails - self.injected


@dataclasses.dataclass
class PoolSqueeze:
    """Hold ``blocks`` KV blocks hostage while now is in [t0, t1)."""
    t0: float
    t1: float
    blocks: int
    held: List[int] = dataclasses.field(default_factory=list)
    done: bool = False           # window passed, blocks released
    applied: bool = False        # ever actually held blocks (report field)

    def active(self) -> bool:
        return bool(self.held)


@dataclasses.dataclass
class DispatchSlowdown:
    """Scale measured ``kind`` dispatch time by ``factor`` in [t0, t1)."""
    t0: float
    t1: float
    factor: float = 2.0
    kind: str = "*"              # "decode" | "prefill" | "*"
    injected: int = 0            # dispatches actually slowed (report field)


class FaultPlan:
    """A deterministic schedule of injected failures for one replay.

    Attach with ``replay_trace(..., faults=plan)`` — the replay calls
    ``advance`` at every scheduling boundary, routes measured dispatch
    times through ``dispatch_dt``, includes ``next_event`` in its idle
    jumps (a squeeze window must open even if the runtime is idle), and
    calls ``finish`` before its final invariant check.  Artifact loaders
    reach the plan through ``runtime.faults`` (set by the replay, or
    manually for unit tests).
    """

    def __init__(self, *,
                 artifact_faults: Optional[List[ArtifactFault]] = None,
                 pool_squeezes: Optional[List[PoolSqueeze]] = None,
                 slowdowns: Optional[List[DispatchSlowdown]] = None):
        self.artifact_faults = list(artifact_faults or [])
        self.pool_squeezes = list(pool_squeezes or [])
        self.slowdowns = list(slowdowns or [])

    def empty(self) -> bool:
        return not (self.artifact_faults or self.pool_squeezes
                    or self.slowdowns)

    # ------------------------------------------------------------ artifacts
    def artifact_check(self, target: str, name: str) -> None:
        """Raise ``ArtifactLoadError`` if an artifact fault with budget
        left matches this load attempt (called by the loaders themselves,
        inside their retry loop — each retry consumes one failure)."""
        for f in self.artifact_faults:
            if f.target == target and f.remaining() > 0 \
                    and fnmatch(str(name), f.name):
                f.injected += 1
                raise ArtifactLoadError(
                    f"injected {target} load failure for {name!r} "
                    f"({f.remaining()} more to come)")

    # ----------------------------------------------------------- pool/time
    def advance(self, runtime, now: float) -> None:
        """Open/close pool-squeeze windows against the virtual clock.

        Blocks are taken through ``runtime.pool.alloc`` (best effort: a
        squeeze never takes more than ``available``, so it pressures the
        pool without deadlocking an already-full one) and freed when the
        window closes.  Idempotent per boundary call."""
        for sq in self.pool_squeezes:
            if sq.done:
                continue
            if not sq.held and sq.t0 <= now < sq.t1:
                n = min(sq.blocks, runtime.pool.available)
                got = runtime.pool.alloc(n) if n > 0 else None
                sq.held = got or []
                if sq.held:
                    sq.applied = True
                    runtime.stats["injected_pool_squeezes"] += 1
            if now >= sq.t1:
                if sq.held:
                    runtime.pool.free(sq.held)
                    sq.held = []
                sq.done = True

    def dispatch_dt(self, kind: str, now: float, dt: float) -> float:
        """Virtual-clock dispatch time after any active slowdowns."""
        for sl in self.slowdowns:
            if sl.t0 <= now < sl.t1 and (sl.kind == "*" or sl.kind == kind):
                dt *= sl.factor
                sl.injected += 1
        return dt

    def next_event(self, now: float) -> Optional[float]:
        """Earliest future window edge — the replay's idle jump must not
        leap over a squeeze opening/closing, or an idle runtime would
        never feel the pressure (and held blocks would leak past t1)."""
        edges = []
        for sq in self.pool_squeezes:
            if sq.done:
                continue
            if not sq.held and now < sq.t0:
                edges.append(sq.t0)
            if now < sq.t1:
                edges.append(sq.t1)
        return min(edges) if edges else None

    def finish(self, runtime) -> None:
        """Release every still-held block (windows past the trace end) —
        the replay calls this before its terminal invariant check, so a
        plan can never leak pool capacity across replays."""
        for sq in self.pool_squeezes:
            if sq.held:
                runtime.pool.free(sq.held)
                sq.held = []
            sq.done = True

    def report(self) -> Dict[str, Any]:
        """What was actually injected (benches log this next to results —
        a chaos run whose faults never fired is a silently-green test)."""
        return {
            "artifact_failures": sum(f.injected
                                     for f in self.artifact_faults),
            "pool_squeezes": sum(1 for s in self.pool_squeezes
                                 if s.applied),
            "slowed_dispatches": sum(s.injected for s in self.slowdowns),
        }
