"""Model operations that a request's tokens need, from the model's shapes:
2 per active weight per token (top-k experts only, plus LoRA on its
targets), causal attention over each token's live context, and the LM head
only where a logit is read.  What the program computes beyond that (every
expert over every row, chunk tails, idle decode rows) is not counted.
"""
from typing import Any, Dict


def per_token(m: Dict[str, Any]) -> float:
    """Operations of one token through every layer, attention excluded,
    LM head excluded."""
    d, h, k, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    attn = d * h * hd + 2 * d * k * hd + h * hd * d
    f = m["d_ff"]
    if m.get("num_experts", 0):
        mlp = d * m["num_experts"] + m["experts_per_token"] * 3 * d * f
    else:
        mlp = 3 * d * f
    lora = 0
    r = m["lora_rank"]
    sites = {"q": (d, h * hd), "k": (d, k * hd), "v": (d, k * hd),
             "o": (h * hd, d)}
    for t in m["lora_targets"]:
        lora += r * sum(sites[t])
    return 2.0 * m["num_layers"] * (attn + mlp + lora)


def attention(m: Dict[str, Any], context: int) -> float:
    """Operations of one query over ``context`` keys in every layer
    (QK^T and PV: 4 hd per key and query head)."""
    window = m.get("sliding_window")
    if window is not None:
        context = min(context, window)
    return 4.0 * m["head_dim"] * m["num_heads"] * context * m["num_layers"]


def lm_head(m: Dict[str, Any]) -> float:
    return 2.0 * m["d_model"] * m["vocab_size"]


def tokens(m: Dict[str, Any], first_pos: int, n: int, logits: int) -> float:
    """Operations of ``n`` tokens at positions first_pos .. first_pos + n - 1
    of one sequence, with ``logits`` rows of the LM head read."""
    if n <= 0:
        return 0.0
    # sum over p of (p + 1) keys, window ignored when it is not reached
    window = m.get("sliding_window")
    if window is None or first_pos + n <= window:
        keys = n * first_pos + n * (n + 1) // 2
        att = 4.0 * m["head_dim"] * m["num_heads"] * keys * m["num_layers"]
    else:
        att = sum(attention(m, p + 1) for p in range(first_pos,
                                                     first_pos + n))
    return n * per_token(m) + att + logits * lm_head(m)
