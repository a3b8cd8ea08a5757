"""End-to-end training example: pretrain a small backbone on a synthetic
corpus, then LoRA-fine-tune it on a shifted distribution with the backbone
frozen — producing exactly the artifact pair (backbone checkpoint +
adapter checkpoint) the serverless system serves (port of
``examples/train_lora.py``).  Training calls no kernel: the training
forward runs plain PyTorch with autograd.  The checkpoint is written in
the reference's layout (``checkpoint/bridge.py::reference_tree``), so
either package reads it.

Run: PYTHONPATH=src python -m repro_torch.examples.train_lora
     [--steps 200] [--device cpu]
"""
from __future__ import annotations

import argparse
import os
from typing import Any, Dict, List, Optional

import torch

from repro_torch.checkpoint.bridge import reference_tree
from repro_torch.checkpoint.store import checkpoint_manifest, save_checkpoint
from repro_torch.configs import get_smoke
from repro_torch.core.lora import tree_leaves
from repro_torch.data.pipeline import lm_batches, synthetic_corpus
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.training.adamw import AdamW, cosine_schedule
from repro_torch.training.train import train_loop


def run(cfg: ModelConfig, params: Dict[str, Any], *, steps: int,
        lora_steps: int, batch: int, seq: int, out: str) -> Dict[str, Any]:
    """Pretrain ``params`` (one adapter, (D, r) / (r, O) LoRA leaves) for
    ``steps`` steps, fine-tune its adapter for ``lora_steps``, save the
    checkpoint under ``out``.  Returns the two loss histories
    (``history``, ``history_ft``), the fine-tune's ``head`` and ``tail``
    10-step means and the checkpoint's ``nbytes``."""
    n = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name} ({n / 1e6:.2f}M params)")

    # --- stage 1: pretrain the backbone -----------------------------------
    corpus = synthetic_corpus(cfg.vocab_size, 200_000, seed=3)
    params, hist = train_loop(
        cfg, params, lm_batches(corpus, batch, seq, seed=1),
        steps=steps, lora_only=False,
        opt=AdamW(lr=cosine_schedule(3e-3, 20, steps)), log_every=25)
    print(f"pretrain loss: {hist[0]:.3f} -> {hist[-1]:.3f}")

    # --- stage 2: LoRA fine-tune on a different distribution --------------
    corpus_ft = synthetic_corpus(cfg.vocab_size, 100_000, seed=11,
                                 order=3, zipf_a=1.15)
    params, hist_ft = train_loop(
        cfg, params, lm_batches(corpus_ft, batch, seq, seed=2),
        steps=lora_steps, lora_only=True,
        opt=AdamW(lr=cosine_schedule(2e-3, 10, lora_steps)),
        log_every=25)
    head = sum(hist_ft[:10]) / min(len(hist_ft), 10)
    tail = sum(hist_ft[-10:]) / min(len(hist_ft), 10)
    print(f"LoRA fine-tune loss: {head:.3f} -> {tail:.3f} (10-step means)")
    assert tail < head, "fine-tuning must reduce loss"

    # --- stage 3: checkpoint backbone + adapter separately -----------------
    os.makedirs(out, exist_ok=True)
    nbytes = save_checkpoint(os.path.join(out, "model"),
                             reference_tree(params, cfg),
                             {"config": cfg.name})
    man = checkpoint_manifest(params)
    print(f"checkpoint: {nbytes / 1e6:.2f} MB — backbone "
          f"{man['backbone_bytes'] / 1e6:.2f} MB, adapter "
          f"{man['adapter_bytes'] / 1e6:.3f} MB "
          f"({100 * man['adapter_bytes'] / man['total_bytes']:.2f}% — the "
          f"paper's 99%-redundancy observation)")
    return {"history": hist, "history_ft": hist_ft, "head": head,
            "tail": tail, "nbytes": nbytes}


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lora-steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--out", default="/tmp/serverless_lora_ckpts")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke("smollm_360m").with_(name="smol-demo", vocab_size=512)
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    # one adapter in the training layout, B = 0 (the reference's init)
    params = tf.init_params(cfg, gen, args.device, lora_adapters=None,
                            lora_b_scale=0.0)
    return run(cfg, params, steps=args.steps, lora_steps=args.lora_steps,
               batch=args.batch, seq=args.seq, out=args.out)


if __name__ == "__main__":
    main()
