"""Training launcher (port of ``repro/launch/train.py``): LoRA fine-tune
any ``--arch`` on the synthetic corpus, backbone frozen.

  python -m repro_torch.launch.train --arch smollm_360m --steps 200
  python -m repro_torch.launch.train --arch llama2_7b --full --batch 4 \\
      --seq 1024 --steps 20

Weights are random from a seeded ``torch.Generator`` (``init_params``
with one adapter, LoRA B = 0 as the reference initialises it); the SMOKE
config unless ``--full``.  VLM and audio configs get all-zero image or
frame embeddings, as in the reference.  ``--ckpt PATH`` saves the
trained model in the reference's period-stacked layout
(``checkpoint/bridge.py::reference_tree``), which the reference's
``load_checkpoint`` and the port's ``bridge.load_params`` both read, and
prints its ``checkpoint_manifest``.  Sharded training over a device mesh
(the reference's ``--mesh``) is not ported: the flag is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.bridge import reference_tree
from repro_torch.checkpoint.store import checkpoint_manifest, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.lora import combine_lora, partition_lora
from repro_torch.data.pipeline import lm_batches, synthetic_corpus
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.training.adamw import AdamW, AdamWState, cosine_schedule
from repro_torch.training.train import make_lora_train_step

CORPUS_TOKENS = 200_000


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm_360m", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--full", action="store_true",
                    help="full-scale config (default: the SMOKE config)")
    ap.add_argument("--mesh", default=None,
                    help="not ported: refused (ROADMAP.md queue 1, item 17)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda")
    return ap


@dataclasses.dataclass
class TrainRun:
    """One fine-tuning run: the frozen backbone, the adapters and optimizer
    state it updates, and the step function and batches it takes."""
    cfg: ModelConfig
    backbone: Any
    adapters: Any
    opt: AdamW
    opt_state: AdamWState
    step_fn: Callable
    data: Iterator[Dict]
    tokens_per_step: int
    losses: List[float] = dataclasses.field(default_factory=list)
    step_s: List[float] = dataclasses.field(default_factory=list)


def setup(args: argparse.Namespace) -> TrainRun:
    if args.mesh:
        raise SystemExit("--mesh: sharded training over a device mesh is "
                         "not ported (ROADMAP.md queue 1, item 17); run "
                         "on one device without it")
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"(LoRA-only training, backbone frozen) on {args.device}")
    gen = torch.Generator(device=args.device)
    gen.manual_seed(0)
    params = tf.init_params(cfg, gen, args.device, lora_adapters=None,
                            lora_b_scale=0.0)
    backbone, adapters = partition_lora(params)
    opt = AdamW(lr=cosine_schedule(args.lr, min(20, args.steps // 10 + 1),
                                   args.steps))
    corpus = synthetic_corpus(cfg.vocab_size, CORPUS_TOKENS, seed=3)
    extras = {}
    if cfg.family == "vlm":
        extras["embeds"] = np.zeros(
            (args.batch, cfg.num_image_tokens, cfg.d_model), np.float32)
    if cfg.family == "audio":
        extras["frame_embeds"] = np.zeros(
            (args.batch, cfg.encoder_seq, cfg.d_model), np.float32)
    return TrainRun(cfg, backbone, adapters, opt, opt.init(adapters),
                    make_lora_train_step(cfg, opt),
                    lm_batches(corpus, args.batch, args.seq, seed=1,
                               extras=extras),
                    args.batch * args.seq)


def train(run: TrainRun, steps: int, log_fn=print) -> TrainRun:
    """``steps`` LoRA steps; each step's loss is read back to the host,
    and its host wall (batch included) recorded in ``run.step_s``."""
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        run.adapters, run.opt_state, m = run.step_fn(
            run.backbone, run.adapters, run.opt_state, next(run.data))
        run.losses.append(float(m["loss"]))
        run.step_s.append(time.perf_counter() - ts)
        if i % 25 == 0 or i == steps - 1:
            tps = (i + 1) * run.tokens_per_step / (time.perf_counter() - t0)
            log_fn(f"step {i:5d} loss {run.losses[-1]:.4f} "
                   f"gnorm {float(m['grad_norm']):.3f} ({tps:.0f} tok/s)")
    log_fn(f"loss: {run.losses[0]:.4f} -> {run.losses[-1]:.4f}")
    return run


def save(run: TrainRun, path: str, arch: str) -> Dict[str, int]:
    """The trained model in the reference's layout at ``path``; returns
    its manifest."""
    full = combine_lora(run.backbone, run.adapters)
    n = save_checkpoint(path, reference_tree(full, run.cfg), {"arch": arch})
    manifest = checkpoint_manifest(full)
    print(f"saved {n / 1e6:.1f} MB -> {path}.npz ; {manifest}")
    return manifest


def main(argv: Optional[List[str]] = None) -> TrainRun:
    args = build_parser().parse_args(argv)
    run = train(setup(args), args.steps)
    if args.ckpt:
        save(run, args.ckpt, args.arch)
    return run


if __name__ == "__main__":
    main()
