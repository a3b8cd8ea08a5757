"""CompileGuard — runtime enforcement of the capture-once contract (port of
``repro/serving/compile_guard.py``).

Any test or bench wraps its serving code in::

    with CompileGuard(max_compiles={"decode": 1, "prefill": 1},
                      runtime=rt):
        replay_trace(rt, trace)

and fails loudly — ``CompileBudgetExceeded`` — if a watched dispatch was
captured more often than its budget while the guard was active.  In the
port a "compile" is a capture: a ``serving.graphs.GraphedDispatch`` sees
a new input signature and captures a new CUDA graph for it (on the CPU it
records the key), which mid-serving is a cold start by another name.

Two measurement channels:

* **per-function** (``max_compiles``): named dispatches registered via
  :meth:`watch` / :meth:`attach`; counts come from their cache-size probe
  (``fn._cache_size()``, the number of keys).  A watched callable without
  the probe is reported as None and not enforced, as in the reference.
* **process-wide** (``max_total``): every capture of every
  ``GraphedDispatch`` in the process (``GraphedDispatch.captures``), which
  takes the place of the reference's JAX compile event.  ``report()``
  always includes the observed total.

The guard never perturbs what it measures: it only reads counts.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.serving.graphs import GraphedDispatch


class CompileBudgetExceeded(AssertionError):
    """A watched dispatch was captured more often than its budget."""


def _cache_size(fn: Any) -> Optional[int]:
    """Capture-count probe; None when ``fn`` has none."""
    try:
        return int(fn._cache_size())
    except AttributeError:
        return None


class CompileGuard:
    """Context manager asserting capture budgets over its body.

    Args:
        max_compiles: budget per watched name, e.g.
            ``{"decode": 1, "prefill": 1}``.  Names without a budget
            are watched (and reported) but unchecked.
        max_total: optional budget on *process-wide* captures while
            active (every ``GraphedDispatch``, not just watched ones).
        runtime: optional ``ContinuousRuntime``; forwarded to
            :meth:`attach` on ``__enter__``.
    """

    def __init__(self, max_compiles: Optional[Dict[str, int]] = None,
                 *, max_total: Optional[int] = None,
                 runtime: Any = None):
        self.max_compiles = dict(max_compiles or {})
        self.max_total = max_total
        self._runtime = runtime
        self._watched: Dict[str, Any] = {}
        self._baseline: Dict[str, Optional[int]] = {}
        self.backend_compiles = 0
        self.backend_compile_seconds = 0.0
        self._base_total = (0, 0.0)
        self._active = False

    # -- registration -----------------------------------------------
    def watch(self, name: str, fn: Any) -> "CompileGuard":
        """Watch a dispatch; its baseline is its current key count (so
        only captures *inside* the guard count)."""
        self._watched[name] = fn
        self._baseline[name] = _cache_size(fn)
        return self

    def attach(self, runtime: Any) -> "CompileGuard":
        """Watch a ContinuousRuntime's decode + prefill dispatches."""
        return self.watch("decode", runtime._decode) \
                   .watch("prefill", runtime._prefill)

    # -- measurement ------------------------------------------------
    def compiles(self, name: str) -> Optional[int]:
        """New captures of ``name`` since it was watched (None when the
        probe is unavailable)."""
        base = self._baseline.get(name)
        now = _cache_size(self._watched[name])
        if base is None or now is None:
            return None
        return now - base

    def _sample_total(self) -> None:
        if self._active:
            self.backend_compiles = (GraphedDispatch.captures
                                     - self._base_total[0])
            self.backend_compile_seconds = (GraphedDispatch.capture_seconds
                                            - self._base_total[1])

    def report(self) -> Dict[str, Any]:
        self._sample_total()
        out: Dict[str, Any] = {
            "backend_compiles": self.backend_compiles,
            "backend_compile_seconds": self.backend_compile_seconds,
        }
        for name in self._watched:
            out[f"{name}_compiles"] = self.compiles(name)
            if name in self.max_compiles:
                out[f"{name}_budget"] = self.max_compiles[name]
        return out

    def check(self) -> None:
        """Raise CompileBudgetExceeded on any blown budget."""
        self._sample_total()
        for name, budget in self.max_compiles.items():
            if name not in self._watched:
                continue
            n = self.compiles(name)
            if n is not None and n > budget:
                raise CompileBudgetExceeded(
                    f"'{name}' compiled {n}x inside CompileGuard "
                    f"(budget {budget}) — a recapture mid-serving is a "
                    f"cold start by another name; every dispatch "
                    f"shape/dtype must be fixed")
        if self.max_total is not None \
                and self.backend_compiles > self.max_total:
            raise CompileBudgetExceeded(
                f"{self.backend_compiles} backend compiles inside "
                f"CompileGuard (budget {self.max_total})")

    # -- context manager --------------------------------------------
    def __enter__(self) -> "CompileGuard":
        if self._runtime is not None:
            self.attach(self._runtime)
        self._base_total = (GraphedDispatch.captures,
                            GraphedDispatch.capture_seconds)
        self._active = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._sample_total()
        self._active = False
        if exc_type is None:
            self.check()
