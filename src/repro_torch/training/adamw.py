"""AdamW and learning-rate schedules (port of ``repro/training/adamw.py``).

Trees are the port's: nested dicts, lists and tuples of tensors with None
leaves (``core/lora.py::partition_lora`` leaves None off the adapters).
The moments are float32 whatever the parameter's dtype, and each update
is written back in the parameter's dtype, as the reference does: a
bfloat16 adapter is rounded every step (there are no float32 master
weights).  The step count is an int32 tensor on the parameters' device
and the schedules are evaluated in float32 there, so a step never reads
a value back to the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Tuple

import torch
import torch.profiler

from repro_torch.core.lora import _zip_map, tree_leaves


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32: updates taken
    mu: Any                     # first moments, float32, the params' tree
    nu: Any                     # second moments


def _update_tree(fn: Callable, g: Any, m: Any, v: Any, p: Any
                 ) -> Tuple[Any, Any, Any]:
    """``fn(g, m, v, p) -> (p', m', v')`` leafwise over trees of one
    structure; returns the three trees.  A None leaf stays None."""
    if isinstance(p, dict):
        outs = {k: _update_tree(fn, g[k], m[k], v[k], p[k]) for k in p}
        return tuple({k: o[i] for k, o in outs.items()} for i in range(3))
    if isinstance(p, (list, tuple)):
        outs = [_update_tree(fn, *xs) for xs in zip(g, m, v, p)]
        return tuple(type(p)(o[i] for o in outs) for i in range(3))
    if g is None or p is None:
        return None, None, None
    return fn(g, m, v, p)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor]
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.01

    def init(self, params: Any) -> AdamWState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else torch.device("cpu")

        def zeros(tree):
            return _zip_map(lambda x: None if x is None else torch.zeros_like(
                x, dtype=torch.float32), tree)

        return AdamWState(torch.zeros((), dtype=torch.int32, device=device),
                          zeros(params), zeros(params))

    @torch.no_grad()
    def update(self, grads: Any, state: AdamWState, params: Any
               ) -> Tuple[Any, AdamWState]:
        """One AdamW step.  Returns (new params, new state): new trees,
        the inputs untouched.  Its ops run under the profiler range
        "AdamW.update"."""
        with torch.profiler.record_function("AdamW.update"):
            return self._update(grads, state, params)

    def _update(self, grads: Any, state: AdamWState, params: Any
                ) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        lr = self.lr(step)
        sf = step.float()
        c1 = 1 - self.b1 ** sf
        c2 = 1 - self.b2 ** sf
        b1, b2 = self.b1, self.b2

        def upd(g, m, v, p):
            g32 = g.float()
            m = b1 * m + (1 - b1) * g32
            v = b2 * v + (1 - b2) * (g32 * g32)
            p32 = p.float()
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps) \
                + self.weight_decay * p32
            return (p32 - lr * delta).to(p.dtype), m, v

        new_p, new_m, new_v = _update_tree(upd, grads, state.mu, state.nu,
                                           params)
        return new_p, AdamWState(step, new_m, new_v)


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``."""
    def lr(step: torch.Tensor) -> torch.Tensor:
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant_schedule(lr_val: float) -> Callable:
    return lambda step: torch.full((), lr_val, dtype=torch.float32,
                                   device=step.device)
