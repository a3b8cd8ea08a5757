"""A cell small enough for the CPU: a checkout root in a temporary
directory with its own BENCHMARK.json, a tiny configuration and a tiny
mix, and the benchmark's readers and counts copied beside them."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]

CONFIG = {
    "source": "tiny test model", "reduced": [],
    "published": {"rms_norm_eps": 1e-05},
    "model": {"family": "dense", "num_layers": 2, "d_model": 64,
              "num_heads": 4, "num_kv_heads": 2, "head_dim": 16,
              "d_ff": 128, "vocab_size": 256, "mlp_type": "swiglu",
              "norm_type": "rmsnorm", "tie_embeddings": False,
              "rope_theta": 10000.0, "sliding_window": None,
              "num_experts": 0, "experts_per_token": 0,
              "dtype": "bfloat16"},
    "lora": {"rank": 4, "alpha": 8.0, "targets": ["q", "k", "v", "o"],
             "adapters": 4},
    "serving": {"num_slots": 8, "block_size": 16, "max_blocks_per_slot": 8,
                "prefill_chunk": 32, "prefill_rows": 2, "decode_chunk": 4,
                "pool_reserve_gib": 0.0, "cpu_blocks": 96},
    "check": {"tokens": 48, "most_requests": 4,
              "limits": {"max_logit_gap": 0.05}},
}

MOE = dict(CONFIG, model=dict(CONFIG["model"], family="moe", num_experts=4,
                              experts_per_token=2))

TRAFFIC = {
    "arrivals": {"kind": "poisson", "rate_per_s": 12.0},
    "preroll_s": 0.5,
    "functions": {"count": 4, "popularity": "zipf", "s": 1.0},
    "shared_prefix_tokens": 32,
    "prompt": {"median": 20, "sigma": 0.5, "min": 8, "max": 48,
               "includes_prefix": False},
    "output": {"median": 8, "sigma": 0.5, "min": 4, "max": 16},
    "slo_ttft_s": 4.0,
}


def make_root(tmp: Path, *, config=CONFIG, traffic=TRAFFIC,
              extra_metrics=()) -> Path:
    """A root whose BENCHMARK.json has one cell, ``tiny.chat``, with the
    real benchmark's metrics (those of its phi3m cells) plus
    ``extra_metrics`` (per-layer metric entries)."""
    root = Path(tmp)
    folder = root / "servebench"
    for sub in ("metrics", "work"):
        shutil.copytree(BENCH / sub, folder / sub)
    (folder / "configs").mkdir()
    (folder / "traffic").mkdir()
    (folder / "configs" / "tiny.json").write_text(json.dumps(config))
    (folder / "traffic" / "tiny-chat.json").write_text(json.dumps(traffic))
    real = json.loads((BENCH.parent / "BENCHMARK.json").read_text())

    def mine(metrics):
        out = []
        for m in metrics:
            if "phi3m.chat-16fn" in m.get("workloads", ["phi3m.chat-16fn"]):
                out.append(dict(m, workloads=["tiny.chat"]))
        return out

    bench = {"command": real["command"], "paths": ["servebench"],
             "run_seconds": 2,
             "configs": [{"name": "tiny", "source": "test",
                          "file": "servebench/configs/tiny.json",
                          "reduced": [], "why": "test"}],
             "workloads": [{"name": "tiny.chat", "config": "tiny",
                            "traffic": "tiny-chat", "chips": 1,
                            "why": "test"}],
             "end_to_end": mine(real["end_to_end"]),
             "per_layer": mine(real["per_layer"]) + list(extra_metrics)}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
