"""Plain reference of the served models, in float32 with TF32 off.

A decoder as its publishers describe it (Phi-3, arXiv:2404.14219; Mixtral,
arXiv:2401.04088): token embedding; per layer RMSNorm, grouped-query
attention with rotary embeddings (the rotate-half form) under a causal
mask, a residual add, RMSNorm and a SwiGLU MLP, or for a mixture of
experts a softmax router whose top k probabilities, renormalised to sum to
one, weight the chosen experts' SwiGLU outputs; a final RMSNorm and the LM
head.  Each LoRA adapter adds scaling * (x @ A) @ B to its projection.

It reads the weights the benchmark drew (``servebench/model.py``'s names,
stacked over layers) and nothing the program made, runs whole sequences
with no cache, and goes layer by layer, each layer's weights cast to
float32 in turn, so that it fits beside the bf16 weights.

``quant="fp8"`` is the control: every product's operands (weights per
output channel, activations per token, keys and values per token) rounded
to float8 e4m3 first, the precision below the bf16 the models are served
in.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """float32 products in float32: TF32 off for the span."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        torch.set_float32_matmul_precision(old[2])


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Round to float8 e4m3 with one scale per slice along ``dim``'s
    complement (the scale's reduction runs over ``dim``)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Ref:
    def __init__(self, config: Dict[str, Any], w: Dict[str, Any],
                 quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant {quant!r}")
        self.m = config["model"]
        self.eps = float(config["published"]["rms_norm_eps"])
        lo = config["lora"]
        self.scaling = lo["alpha"] / lo["rank"]
        self.w = w
        self.quant = quant
        self.margins: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ pieces
    def weight(self, t: torch.Tensor) -> torch.Tensor:
        """A (d_in, d_out) weight in float32 (control: per output channel
        in fp8)."""
        t = t.to(torch.float32)
        return fp8(t, 0) if self.quant else t

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return fp8(x, -1) if self.quant else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.act(x) @ w

    def norm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * scale.to(torch.float32)

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (T, n, hd) at positions pos (T,): the rotate-half form."""
        hd = x.shape[-1]
        half = hd // 2
        inv = self.m["rope_theta"] ** (-torch.arange(
            0, half, dtype=torch.float64, device=x.device) / half)
        ang = pos.to(torch.float64)[:, None] * inv[None]
        cos = torch.cos(ang).to(torch.float32)[:, None, :]
        sin = torch.sin(ang).to(torch.float32)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def attention(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  block: int = 512) -> torch.Tensor:
        """Causal GQA: q (T, H, hd), k and v (T, K, hd) -> (T, H * hd)."""
        T, H, hd = q.shape
        K = k.shape[1]
        g = H // K
        window = self.m.get("sliding_window")
        qg = q.reshape(T, K, g, hd).permute(1, 2, 0, 3)       # (K, g, T, hd)
        kk = k.permute(1, 2, 0)                               # (K, hd, T)
        vv = v.permute(1, 0, 2)                               # (K, T, hd)
        out = torch.empty((K, g, T, hd), dtype=torch.float32,
                          device=q.device)
        keys = torch.arange(T, device=q.device)
        for s in range(0, T, block):
            e = min(s + block, T)
            sc = torch.matmul(qg[:, :, s:e], kk[:, None]) / math.sqrt(hd)
            qpos = keys[s:e, None]
            mask = keys[None] > qpos
            if window is not None:
                mask |= keys[None] <= qpos - window
            sc = sc.masked_fill(mask, float("-inf"))
            out[:, :, s:e] = torch.matmul(torch.softmax(sc, dim=-1),
                                          vv[:, None])
        return out.permute(2, 0, 1, 3).reshape(T, H * hd)

    def lora(self, x: torch.Tensor, site: str, layer: int,
             adapter: int) -> Optional[torch.Tensor]:
        ab = self.w["lora"].get(site)
        if ab is None:
            return None
        a = self.weight(ab["a"][layer, adapter])
        b = self.weight(ab["b"][layer, adapter])
        return self.scaling * self.mm(self.mm(x, a), b)

    def proj(self, x, wt, site, layer, adapter):
        y = self.mm(x, wt)
        d = self.lora(x, site, layer, adapter)
        return y if d is None else y + d

    def swiglu(self, x, gate, up, down) -> torch.Tensor:
        h = torch.nn.functional.silu(self.mm(x, gate)) * self.mm(x, up)
        return self.mm(h, down)

    def mlp(self, x: torch.Tensor, layer: int) -> torch.Tensor:
        """The MLP over every token of every sequence at once."""
        w = self.w
        if not self.m.get("num_experts", 0):
            return self.swiglu(x, self.weight(w["gate"][layer]),
                               self.weight(w["up"][layer]),
                               self.weight(w["down"][layer]))
        logits = self.mm(x, self.weight(w["router"][layer]))
        probs = torch.softmax(logits, dim=-1)
        k = self.m["experts_per_token"]
        if self.margins is not None:
            top = torch.topk(logits, k + 1, dim=-1).values
            m = top[:, k - 1] - top[:, k]
            self.margins = m if self.margins.numel() == 0 else \
                torch.minimum(self.margins, m)
        topw, topi = torch.topk(probs, k, dim=-1)
        topw = topw / topw.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(self.m["num_experts"]):
            rows, slot = torch.nonzero(topi == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            y = self.swiglu(x[rows], self.weight(w["gate"][layer, e]),
                            self.weight(w["up"][layer, e]),
                            self.weight(w["down"][layer, e]))
            out.index_add_(0, rows, y * topw[rows, slot, None])
        return out

    # ------------------------------------------------------------ forward
    @torch.no_grad()
    def logits(self, seqs: Sequence[Tuple[torch.Tensor, int, int]],
               margins: bool = False):
        """Each of ``seqs`` is (token ids (T,), adapter, first position
        whose logits are read); returns the float32 logits of positions
        first .. T - 1 of each.  With ``margins`` (a mixture of experts),
        also each such position's smallest gap, over the layers, between
        the router logit of its last chosen expert and the best one left
        out."""
        m, w = self.m, self.w
        self.margins = torch.zeros(0) if margins else None
        H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        with exact_float32():
            hs = [w["embed"][t.long()].to(torch.float32) for t, _, _ in seqs]
            for layer in range(m["num_layers"]):
                wq, wk, wv, wo = (self.weight(w[n][layer])
                                  for n in ("wq", "wk", "wv", "wo"))
                n1 = w["norms"][layer, 0]
                for i, (tok, ad, _) in enumerate(seqs):
                    x = hs[i]
                    T = x.shape[0]
                    pos = torch.arange(T, device=x.device)
                    h = self.norm(x, n1)
                    q = self.rope(self.proj(h, wq, "q", layer, ad)
                                  .reshape(T, H, hd), pos)
                    k = self.rope(self.proj(h, wk, "k", layer, ad)
                                  .reshape(T, K, hd), pos)
                    v = self.proj(h, wv, "v", layer, ad).reshape(T, K, hd)
                    if self.quant:
                        k, v = fp8(k, -1), fp8(v, -1)
                    o = self.attention(q, k, v)
                    hs[i] = x + self.proj(o, wo, "o", layer, ad)
                del wq, wk, wv, wo
                sizes = [x.shape[0] for x in hs]
                x = torch.cat(hs)
                x = x + self.mlp(self.norm(x, w["norms"][layer, 1]), layer)
                hs = list(torch.split(x, sizes))
            head = w["lm_head"] if "lm_head" in w else w["embed"].T
            head = self.weight(head)
            out = []
            for x, (_, _, first) in zip(hs, seqs):
                out.append(self.mm(self.norm(x[first:], w["final_norm"]),
                                   head))
            if not margins:
                return out
            per = torch.split(self.margins, [t.shape[0] for t, _, _ in seqs])
            return out, [p[first:] for p, (_, _, first) in zip(per, seqs)]
