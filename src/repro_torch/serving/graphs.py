"""Fixed-shape dispatches captured once as CUDA graphs: the port's form of
``jax.jit`` for the serving runtime's decode and prefill chunks and the
ring engine's decode step.

A ``GraphedDispatch`` wraps a step function of tensors and keys it by the
signature of its inputs (shape and dtype of each).  It owns one set of
static input buffers per key; each call copies the caller's host arrays
into them through pinned staging buffers (device tensors go straight
across) and then runs the step:

* on the card, the first call with a key runs the function eagerly once
  on a side stream — which builds and loads the kernel library, sets the
  kernels' shared-memory attributes and loads lazily loaded modules
  outside any capture — then captures it into a ``torch.cuda.CUDAGraph``
  and replays it.  Later calls with the key only stage and replay.
  Nothing falls back to eager: a capture that fails raises.  The tensors
  named in ``keep`` are put back as they were before that eager run: a
  step that advances a recurrent state in place (the ring engine's REC
  and SSD layers) would otherwise advance it twice, once eagerly and
  once in the replay; a K/V write at the step's own slot is the same
  write twice and needs no keeping.
* on the CPU it runs the function and records the key.

``_cache_size()`` is the number of keys, the probe ``CompileGuard`` reads
(as the reference's guard reads jit's cache size).  ``captures`` and
``capture_seconds`` on the class count every new key of every dispatch in
the process: the guard's process-wide channel.

The kernel wrappers count launches in Python, and a replay runs no
Python: each capture records what every wrapper counted while it was
captured, takes that back (a capture launches nothing), and adds it again
on every replay.  The graph's outputs are cloned after each replay, so a
caller may keep them across later calls.  All graphs of one owner share
one memory pool: they replay one at a time on one stream, and nothing of
a graph's pool is read after the next replay except the clones.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels

Key = Tuple[Optional[Tuple[Tuple[int, ...], torch.dtype]], ...]


def _as_cpu_tensor(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def _signature(args: Sequence[Any]) -> Key:
    """(shape, dtype) of every argument; None stays None."""
    out = []
    for a in args:
        if a is None:
            out.append(None)
        else:
            t = _as_cpu_tensor(a)
            out.append((tuple(t.shape), t.dtype))
    return tuple(out)


def _clone(out: Any) -> Any:
    if isinstance(out, torch.Tensor):
        return out.clone()
    return type(out)(_clone(o) for o in out)


class _Inputs:
    """Static input buffers of one key, and their pinned staging copies on
    the card."""

    def __init__(self, key: Key, device: torch.device):
        self.device = device
        self.static: List[Optional[torch.Tensor]] = [
            None if k is None else torch.empty(k[0], dtype=k[1],
                                               device=device)
            for k in key]
        cuda = device.type == "cuda"
        self.pinned = [None if (k is None or not cuda) else
                       torch.empty(k[0], dtype=k[1], pin_memory=True)
                       for k in key]
        self.copied = torch.cuda.Event() if cuda else None

    def stage(self, args: Sequence[Any]) -> None:
        """Copy the caller's values into the static buffers (on the card:
        host values through the pinned buffers, without waiting for the
        device, after the previous call's copies out of them have run)."""
        if self.copied is not None:
            self.copied.synchronize()
        for a, buf, pin in zip(args, self.static, self.pinned):
            if a is None:
                continue
            if isinstance(a, torch.Tensor) and a.device.type != "cpu":
                buf.copy_(a)
            elif pin is None:
                buf.copy_(_as_cpu_tensor(a))
            else:
                pin.copy_(_as_cpu_tensor(a))
                buf.copy_(pin, non_blocking=True)
        if self.copied is not None:
            self.copied.record()


class _Graph:
    def __init__(self, inputs: _Inputs):
        self.inputs = inputs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Any = None
        self.launches: Dict[str, int] = {}


class GraphedDispatch:
    """A step function run as one captured graph per input signature (see
    the module docstring).  ``device`` is where the step's tensors live;
    ``pool`` is a ``torch.cuda.graph_pool_handle()`` shared with the
    owner's other dispatches; ``keep`` the tensors that the eager run
    before a capture must leave as it found them."""

    captures = 0               # every new key of every dispatch, process-wide
    capture_seconds = 0.0

    def __init__(self, fn: Callable[..., Any], device, *, pool=None,
                 keep: Sequence[torch.Tensor] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.keep = tuple(keep)
        self._graphs: Dict[Key, _Graph] = {}
        self._last: Optional[_Graph] = None

    def _cache_size(self) -> int:
        return len(self._graphs)

    def eager(self, *args: Any) -> Any:
        """The same function, uncaptured, on fresh copies of ``args`` (for
        comparisons; nothing on the serving path calls it)."""
        ins = _Inputs(_signature(args), self.device)
        ins.stage(args)
        return self.fn(*ins.static)

    def __call__(self, *args: Any) -> Any:
        key = _signature(args)
        g = self._graphs.get(key)
        if g is None:
            g = self._new_key(key, args)
        else:
            g.inputs.stage(args)
        self._last = g
        return self._run(g)

    def replay(self) -> Any:
        """Run the last called key again on its input buffers as they stand
        (for a step that advances its own inputs in place)."""
        if self._last is None:
            raise RuntimeError("replay() before any call")
        return self._run(self._last)

    def _run(self, g: _Graph) -> Any:
        if g.graph is None:
            return self.fn(*g.inputs.static)
        g.graph.replay()
        kernels.add_launches(g.launches)
        return _clone(g.out)

    def _new_key(self, key: Key, args: Sequence[Any]) -> _Graph:
        t0 = time.perf_counter()
        g = _Graph(_Inputs(key, self.device))
        g.inputs.stage(args)
        if self.device.type == "cuda":
            self._capture(g, args)
        # a key counts once its graph exists: a failed capture raises and
        # leaves no key behind to run uncaptured
        self._graphs[key] = g
        GraphedDispatch.captures += 1
        GraphedDispatch.capture_seconds += time.perf_counter() - t0
        return g

    def _capture(self, g: _Graph, args: Sequence[Any]) -> None:
        static = g.inputs.static
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        saved = [t.clone() for t in self.keep]
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.fn(*static)
        cur.wait_stream(side)
        for t, was in zip(self.keep, saved):
            t.copy_(was)
        del saved
        # the eager run may have advanced inputs in place: stage again
        g.inputs.stage(args)
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # A graph left unreachable in a reference cycle (say, an engine
        # that owned it) must not be freed by the collector mid-capture:
        # destroying a graph while a stream captures invalidates the
        # capture.  So collect first, and let nothing collect during it.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                out = self.fn(*static)
        finally:
            if collecting:
                gc.enable()
        after = kernels.launch_counts()
        g.launches = {k: after[k] - before[k] for k in after}
        kernels.add_launches({k: -n for k, n in g.launches.items()})
        g.graph, g.out = graph, out
