"""What decides ``correct``: the served tokens against the plain reference.

Once the window has closed, a sample of the requests the program finished
is drawn from the seed, the longest of them always in it, until it holds
``check.tokens`` served tokens.  The reference runs once over each prompt
with its served tokens; at each served token it reads how far that token's
logit lies below its own best one.  The widest such gap over the sample is
compared with the configuration's limit.  The program decodes greedily, so
a sound run serves tokens whose gap is rounding alone.

The control puts the reference computed in float8 in the program's place:
at each position of the same sequences, the gap of the token that the
float8 run puts first.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from servebench.reference.model import Ref
from servebench.traffic import rng_for


def sample(records: Sequence[Any], seed: int, tokens: int,
           most: int) -> List[Any]:
    """Finished requests: the longest, then others in a seeded order, until
    ``tokens`` served tokens or ``most`` requests."""
    done = [r for r in records
            if not r.failed and len(r.tokens) == r.req.output_len]
    if not done:
        return []
    done.sort(key=lambda r: r.req.rid)
    longest = max(done, key=lambda r: (len(r.req.prompt) + len(r.tokens),
                                       -r.req.rid))
    rest = [r for r in done if r is not longest]
    order = rng_for(seed, 3).permutation(len(rest))
    out, n = [longest], len(longest.tokens)
    for i in order:
        if n >= tokens or len(out) >= most:
            break
        out.append(rest[i])
        n += len(rest[i].tokens)
    return out


def sequences(picked: Sequence[Any], device) -> List:
    """(prompt + served tokens but the last, adapter, first logit row)."""
    seqs = []
    for r in picked:
        ids = np.concatenate([r.req.prompt,
                              np.asarray(r.tokens[:-1], np.int32)])
        seqs.append((torch.from_numpy(ids).to(device), r.req.fn,
                     len(r.req.prompt) - 1))
    return seqs


def gaps(ref_logits: Sequence[torch.Tensor],
         chosen: Sequence[torch.Tensor]) -> np.ndarray:
    """Per position: the reference's best logit minus its logit of the
    chosen token."""
    out = []
    for lg, tok in zip(ref_logits, chosen):
        best = lg.max(dim=-1).values
        got = lg.gather(1, tok.long().to(lg.device)[:, None])[:, 0]
        out.append((best - got).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def numbers(g: np.ndarray) -> Dict[str, float]:
    """The numbers a check can compare: the widest gap, the mean gap, and
    the share of tokens that are not the reference's best."""
    return {"max_logit_gap": float(g.max()),
            "mean_logit_gap": float(g.mean()),
            "off_best_share": float((g > 0).mean())}


def routed(g: np.ndarray, keep: np.ndarray) -> Dict[str, float]:
    """The gaps of the tokens whose expert choice the reference makes with
    a router margin of at least ``check.router_margin`` at every layer."""
    if not keep.any():
        return {"routed_share": 0.0}
    return {"routed_mean_logit_gap": float(g[keep].mean()),
            "routed_max_logit_gap": float(g[keep].max()),
            "routed_share": float(keep.mean())}


def check(config: Dict[str, Any], weights: Dict[str, Any],
          records: Sequence[Any], seed: int, device, *,
          control: bool = False) -> Dict[str, Any]:
    c = config["check"]
    picked = sample(records, seed, c["tokens"], c["most_requests"])
    if not picked:
        return {"requests": 0, "tokens": 0, "numbers": {}}
    seqs = sequences(picked, device)
    moe = bool(config["model"].get("num_experts", 0))
    ref = Ref(config, weights).logits(seqs, margins=moe)
    margin = None
    if moe:
        ref, margin = ref
        margin = torch.cat(margin).cpu().numpy()
    served = [torch.tensor(r.tokens, dtype=torch.int64) for r in picked]
    g = gaps(ref, served)
    out = {"requests": len(picked), "tokens": int(g.size),
           "numbers": numbers(g)}
    tau = c.get("router_margin")
    if margin is not None and tau is not None:
        keep = margin >= tau
        out["numbers"].update(routed(g, keep))
    if control:
        low = Ref(config, weights, quant="fp8").logits(seqs)
        gc = gaps(ref, [lg.argmax(dim=-1) for lg in low])
        out["control"] = numbers(gc)
        if margin is not None and tau is not None:
            out["control"].update(routed(gc, margin >= tau))
    return out
