"""The system under test, built from a configuration file and a seed.

The benchmark draws every weight itself, on the device, from the seed: one
``normal_`` call per kind of leaf over all layers at once (all layers' query
projections in one tensor, and so on), in the type the model is served in.
The program is handed views of these tensors in its parameter layout, and
the plain reference reads the same tensors under their published names.
The adapters are drawn the same way; the program's bank starts empty and
``AdapterRegistry.load`` writes each function's adapter into it.
"""
from __future__ import annotations

import dataclasses
import gc
from typing import Any, Dict, List, Tuple

import torch

from repro_torch.models.config import LoRAConfig, ModelConfig
from repro_torch.serving.adapters import AdapterRegistry
from repro_torch.serving.runtime import ContinuousRuntime, ServingConfig

MODEL_KEYS = ("family", "num_layers", "d_model", "num_heads", "num_kv_heads",
              "d_ff", "vocab_size", "head_dim", "mlp_type", "norm_type",
              "tie_embeddings", "rope_theta", "sliding_window",
              "num_experts", "experts_per_token", "dtype")


def model_config(config: Dict[str, Any]) -> ModelConfig:
    m, lo = config["model"], config["lora"]
    return ModelConfig(name=config["name"], source=config["source"],
                       lora=LoRAConfig(rank=lo["rank"], alpha=lo["alpha"],
                                       targets=tuple(lo["targets"]),
                                       num_adapters=lo["adapters"]),
                       **{k: m[k] for k in MODEL_KEYS if k in m})


def shapes(config: Dict[str, Any]) -> Dict[str, Any]:
    """The flat shape dictionary the frozen counts read."""
    m, lo = config["model"], config["lora"]
    out = {k: m.get(k) for k in MODEL_KEYS}
    out.update(lora_rank=lo["rank"], lora_targets=list(lo["targets"]),
               adapters=lo["adapters"])
    out.setdefault("num_experts", 0)
    return out


def lora_sites(m: Dict[str, Any]) -> Dict[str, Tuple[int, int]]:
    d, h, k, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], \
        m["head_dim"]
    return {"q": (d, h * hd), "k": (d, k * hd), "v": (d, k * hd),
            "o": (h * hd, d)}


def draw_weights(config: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    """Every weight of the model and its adapters under published names,
    stacked over layers: N(0, 1/d_in) projections, N(0, 1/F) down
    projections, N(0, 0.02) embedding, LM head and adapter B, N(0, 1/d_in)
    adapter A, norm scales 1 + N(0, 0.1)."""
    m, lo = config["model"], config["lora"]
    dt = getattr(torch, m["dtype"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    L, d, f, v = m["num_layers"], m["d_model"], m["d_ff"], m["vocab_size"]
    h, k, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]

    def normal(shape, std, mean=0.0):
        return torch.empty(shape, dtype=dt, device=device).normal_(
            mean, std, generator=gen)

    w: Dict[str, Any] = {
        "embed": normal((v, d), 0.02),
        "final_norm": normal((d,), 0.1, 1.0),
        "norms": normal((L, 2, d), 0.1, 1.0),
        "wq": normal((L, d, h * hd), d ** -0.5),
        "wk": normal((L, d, k * hd), d ** -0.5),
        "wv": normal((L, d, k * hd), d ** -0.5),
        "wo": normal((L, h * hd, d), (h * hd) ** -0.5),
    }
    if not m.get("tie_embeddings", True):
        w["lm_head"] = normal((d, v), 0.02)
    e = m.get("num_experts", 0)
    if e:
        w["router"] = normal((L, d, e), d ** -0.5)
        w["gate"] = normal((L, e, d, f), d ** -0.5)
        w["up"] = normal((L, e, d, f), d ** -0.5)
        w["down"] = normal((L, e, f, d), f ** -0.5)
    else:
        w["gate"] = normal((L, d, f), d ** -0.5)
        w["up"] = normal((L, d, f), d ** -0.5)
        w["down"] = normal((L, f, d), f ** -0.5)
    n, r = lo["adapters"], lo["rank"]
    w["lora"] = {}
    for site, (din, dout) in lora_sites(m).items():
        if site in lo["targets"]:
            w["lora"][site] = {"a": normal((L, n, din, r), din ** -0.5),
                               "b": normal((L, n, r, dout), 0.02)}
    return w


def program_params(config: Dict[str, Any], w: Dict[str, Any]
                   ) -> Dict[str, Any]:
    """The program's parameter tree over the same tensors, with an empty
    adapter bank of its own."""
    m = config["model"]
    moe = bool(m.get("num_experts", 0))
    layers: List[Dict[str, Any]] = []
    for i in range(m["num_layers"]):
        attn = {"wq": {"w": w["wq"][i]}, "wk": {"w": w["wk"][i]},
                "wv": {"w": w["wv"][i]}, "wo": {"w": w["wo"][i]},
                "lora": {s: {"a": torch.zeros_like(ab["a"][i]),
                             "b": torch.zeros_like(ab["b"][i])}
                         for s, ab in w["lora"].items()}}
        layer = {"norm1": {"scale": w["norms"][i, 0]}, "attn": attn,
                 "norm2": {"scale": w["norms"][i, 1]}}
        if moe:
            layer["moe"] = {"router": {"w": w["router"][i]},
                            "wi": w["up"][i], "wg": w["gate"][i],
                            "wo": w["down"][i]}
        else:
            layer["mlp"] = {"wi": {"w": w["up"][i]}, "wg": {"w": w["gate"][i]},
                            "wo": {"w": w["down"][i]}}
        layers.append(layer)
    p = {"embed": w["embed"], "layers": layers,
         "final_norm": {"scale": w["final_norm"]}}
    if "lm_head" in w:
        p["lm_head"] = w["lm_head"]
    return p


def adapter_tree(params: Dict[str, Any], w: Dict[str, Any], n: int) -> Any:
    """Adapter ``n`` in the layout ``AdapterRegistry.load`` takes: the
    parameter tree with None off the LoRA leaves."""
    def walk(node, layer, under):
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                if under is not None and key in ("a", "b"):
                    out[key] = w["lora"][under][key][layer, n]
                elif key == "lora":
                    out[key] = {s: walk(v, layer, s) for s, v in val.items()}
                else:
                    out[key] = walk(val, layer, under)
            return out
        if isinstance(node, list):
            return [walk(x, i, under) for i, x in enumerate(node)]
        return None
    return {key: (walk(val, None, None) if key != "layers" else
                  [walk(x, i, None) for i, x in enumerate(val)])
            for key, val in params.items()}


def block_bytes(config: Dict[str, Any]) -> int:
    m, s = config["model"], config["serving"]
    es = torch.tensor([], dtype=getattr(torch, m["dtype"])).element_size()
    return (2 * m["num_layers"] * m["num_kv_heads"] * s["block_size"]
            * m["head_dim"] * es)


def pool_blocks(config: Dict[str, Any], device) -> int:
    """Whole blocks in what the card has free after the weights and the
    bank, less the configuration's reserve for warm-up and capture; on
    the CPU, the configuration's ``cpu_blocks``."""
    s = config["serving"]
    if torch.device(device).type != "cuda":
        return int(s["cpu_blocks"])
    free, _ = torch.cuda.mem_get_info()
    reserve = int(s["pool_reserve_gib"] * (1 << 30))
    return max(int((free - reserve) // block_bytes(config)), 2)


def serving_config(config: Dict[str, Any], num_blocks: int) -> ServingConfig:
    s = config["serving"]
    return ServingConfig(num_slots=s["num_slots"],
                         block_size=s["block_size"], num_blocks=num_blocks,
                         max_blocks_per_slot=s["max_blocks_per_slot"],
                         prefill_chunk=s["prefill_chunk"],
                         prefill_rows=s["prefill_rows"],
                         decode_chunk=s["decode_chunk"])


@dataclasses.dataclass
class System:
    cfg: ModelConfig
    weights: Dict[str, Any]
    rt: ContinuousRuntime
    fn_names: List[str]
    num_blocks: int


def build(config: Dict[str, Any], seed: int, device) -> System:
    """Weights, runtime, the bank loaded through the registry, and both
    dispatches warmed up (captured on the card)."""
    cfg = model_config(config)
    w = draw_weights(config, seed, device)
    params = program_params(config, w)
    nb = pool_blocks(config, device)
    rt = ContinuousRuntime(cfg, params, serving_config(config, nb),
                           device=device)
    reg = AdapterRegistry(rt)
    names = [f"fn{i}" for i in range(config["lora"]["adapters"])]
    for i, name in enumerate(names):
        reg.load(name, adapter_tree(params, w, i))
    rt.warmup()
    return System(cfg, w, rt, names, nb)


def free_program(system: System) -> None:
    """Drop the runtime (pool, graphs, bank); the weights stay for the
    reference."""
    system.rt = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
