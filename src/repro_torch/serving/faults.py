"""Artifact-load failures and the one retry primitive (the part of
``repro/serving/faults.py`` that the adapter registry needs).

``retry_with_backoff`` is what ``AdapterRegistry.load``/``swap`` wrap each
bank write in: bounded attempts, exponential backoff, and an injectable
``sleep`` so tests never wait on a real clock.  The reference's
``FaultPlan`` (injected artifact faults, pool squeezes, dispatch
slowdowns) is not ported yet; the runtime carries ``faults = None``, as
the reference does without a plan.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple


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
