"""The one traffic generator: a mix's parameters in, requests out.

A mix file (``traffic/<mix>.json``) holds:

* ``arrivals``: ``{"kind": "poisson", "rate_per_s": r}`` (open loop) or
  ``{"kind": "backlog", "count": n}`` (every request due at once, at the
  start of the pre-roll);
* ``preroll_s``: seconds of the same traffic served before the window, so
  that the slots are at steady occupancy when it opens;
* ``functions``: ``{"count": k, "popularity": "zipf", "s": 1.0}`` or
  ``"uniform"``; function i is served by adapter i;
* ``shared_prefix_tokens``: tokens that every request of a function starts
  with (its system prompt or instruction), drawn once per function;
* ``prompt`` and ``output``: lognormal lengths ``{"median", "sigma", "min",
  "max"}``; ``prompt.includes_prefix`` says whether the drawn length is
  the whole prompt or the part after the shared prefix;
* ``slo_ttft_s``: the first-token limit the admission scheduler plans with;
* ``schedule_seed``: where present, the order of gaps, lengths and
  function ids is drawn from it and not from the run's seed, so that every
  run replays one schedule.

Gaps, lengths and function ids are stratified draws (``arrivals.py``) in a
drawn order; token ids (and the model's weights) are drawn from the run's
seed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List

import numpy as np

from servebench import arrivals as ar

SEED_MASK = (1 << 64) - 1


@dataclasses.dataclass
class Req:
    rid: int
    fn: int
    due: float              # seconds from the window's start; < 0 in the
    #   pre-roll
    prompt: np.ndarray      # int32 token ids
    output_len: int


def rng_for(seed: int, salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) & SEED_MASK, salt])


def count_requests(traffic: Dict[str, Any], seconds: float) -> int:
    a = traffic["arrivals"]
    if a["kind"] == "backlog":
        return int(a["count"])
    span = float(traffic.get("preroll_s", 0.0)) + float(seconds)
    return int(math.ceil(a["rate_per_s"] * span * 1.05)) + 1


def function_shares(traffic: Dict[str, Any]) -> np.ndarray:
    f = traffic["functions"]
    k = int(f["count"])
    if f["popularity"] == "zipf":
        return ar.zipf_shares(k, float(f.get("s", 1.0)))
    if f["popularity"] == "uniform":
        return np.full(k, 1.0 / k)
    raise ValueError(f"popularity {f['popularity']!r}")


def generate(traffic: Dict[str, Any], vocab: int, seed: int,
             seconds: float) -> List[Req]:
    """The requests of one run, in due order."""
    n = count_requests(traffic, seconds)
    preroll = float(traffic.get("preroll_s", 0.0))
    a = traffic["arrivals"]
    order = rng_for(traffic.get("schedule_seed", seed), 1)
    if a["kind"] == "backlog":
        due = np.full(n, -preroll)
    elif a["kind"] == "poisson":
        gaps = order.permutation(ar.exponential_quantiles(
            n, 1.0 / float(a["rate_per_s"])))
        due = -preroll + np.cumsum(gaps)
    else:
        raise ValueError(f"arrivals {a['kind']!r}")
    fns = ar.function_sequence(n, function_shares(traffic), order)
    p, o = traffic["prompt"], traffic["output"]
    plen = order.permutation(ar.lognormal_quantiles(
        n, p["median"], p["sigma"], p["min"], p["max"]))
    olen = order.permutation(ar.lognormal_quantiles(
        n, o["median"], o["sigma"], o["min"], o["max"]))
    shared = int(traffic.get("shared_prefix_tokens", 0))
    tok = rng_for(seed, 2)
    k = int(traffic["functions"]["count"])
    prefixes = tok.integers(0, vocab, size=(k, shared), dtype=np.int32)
    reqs = []
    for i in range(n):
        body = int(plen[i]) - (shared if p.get("includes_prefix") else 0)
        if body < 1:
            raise ValueError(f"prompt length {plen[i]} leaves no tokens "
                             f"after a {shared}-token prefix")
        prompt = np.concatenate([prefixes[fns[i]], tok.integers(
            0, vocab, size=body, dtype=np.int32)])
        reqs.append(Req(rid=i, fn=int(fns[i]), due=float(due[i]),
                        prompt=prompt, output_len=int(olen[i])))
    return reqs
