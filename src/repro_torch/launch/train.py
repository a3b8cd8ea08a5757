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
prints its ``checkpoint_manifest``.

``--mesh dxm`` trains over a ("data", "model") device mesh of d x m ranks,
which must be the whole world of ``torchrun`` (NCCL on the card, gloo on
the CPU; without ``torchrun``, a world of one rank):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
      --mesh 2x2 --steps 3

The backbone is distributed by ``launch/sharding.py::params_specs(...,
OPTIMIZED)`` as the reference's launcher does (each rank cuts its shard
from the same seeded weights); adapters, optimizer state and batches are
replicated DTensors, and ``forward_train`` runs on DTensors.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.bridge import reference_tree
from repro_torch.checkpoint.store import checkpoint_manifest, save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.core.lora import _zip_map, combine_lora, partition_lora
from repro_torch.data.pipeline import lm_batches, synthetic_corpus
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.training.adamw import AdamW, AdamWState, cosine_schedule
from repro_torch.training.train import batch_to, make_lora_train_step

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
                    help="dxm: train over a (data, model) mesh of the "
                         "torchrun world (d * m ranks)")
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
    device: torch.device = torch.device("cpu")
    mesh: Any = None
    losses: List[float] = dataclasses.field(default_factory=list)
    step_s: List[float] = dataclasses.field(default_factory=list)


def _rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _log(*a, **kw) -> None:
    """print, on rank 0 of a world (every rank runs the same steps)."""
    if _rank0():
        print(*a, **kw)


def parse_mesh(text: str) -> Tuple[int, int]:
    d, m = (int(x) for x in text.lower().split("x"))
    return d, m


def mesh_for(text: str, device: str):
    """The ("data", "model") mesh ``--mesh dxm`` names, over the world
    (joined here when no process group is up); d * m must be its size."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_world, make_mesh
    d, m = parse_mesh(text)
    started = not dist.is_initialized()
    init_world("gloo" if torch.device(device).type == "cpu" else "nccl")
    world = dist.get_world_size()
    if d * m != world:
        if started:
            dist.destroy_process_group()
        raise ValueError(f"--mesh {text}: {d * m} ranks for a world of "
                         f"{world}; run under torchrun --nproc-per-node "
                         f"{d * m}")
    return make_mesh((d, m), ("data", "model"))


def _replicated(tree, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    rep = [Replicate()] * mesh.ndim
    return _zip_map(lambda x: None if x is None else DTensor.from_local(
        x, mesh, rep, run_check=False), tree)


def _local(tree):
    """DTensor leaves as whole plain tensors (replicated ones without a
    collective)."""
    from torch.distributed.tensor import DTensor
    return _zip_map(lambda x: x.full_tensor()
                    if isinstance(x, DTensor) else x, tree)


def shard(run: TrainRun, mesh) -> TrainRun:
    """``run`` over ``mesh``: the backbone cut by ``params_specs(...,
    OPTIMIZED)``, adapters and optimizer state replicated, every batch
    replicated; the step runs under implicit replication (the model's own
    plain tensors, positions and masks, count as replicated), and its
    metrics come back as plain tensors."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.sharding import (OPTIMIZED, params_specs,
                                             shard_of, to_placements)
    specs = params_specs(run.backbone, mesh, run.cfg, OPTIMIZED)

    def place(t, spec):
        return DTensor.from_local(shard_of(t, spec, mesh), mesh,
                                  to_placements(spec, mesh), run_check=False)

    run.backbone = _zip_map(lambda t, s: None if t is None else place(t, s),
                            run.backbone, specs)
    run.adapters = _replicated(run.adapters, mesh)
    run.opt_state = AdamWState(*_replicated(tuple(run.opt_state), mesh))
    step_fn, device = run.step_fn, run.device

    def sharded_step(backbone, adapters, opt_state, batch):
        batch = _replicated(batch_to(batch, device), mesh)
        with implicit_replication():
            adapters, opt_state, m = step_fn(backbone, adapters, opt_state,
                                             batch)
        return adapters, opt_state, _local(m)

    run.step_fn = sharded_step
    run.mesh = mesh
    return run


def setup(args: argparse.Namespace) -> TrainRun:
    mesh = mesh_for(args.mesh, args.device) if args.mesh else None
    cfg = get_config(args.arch) if args.full else get_smoke(args.arch)
    _log(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
         f"(LoRA-only training, backbone frozen) on {args.device}"
         + (f", mesh {args.mesh}" if mesh is not None else ""))
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
    run = TrainRun(cfg, backbone, adapters, opt, opt.init(adapters),
                   make_lora_train_step(cfg, opt),
                   lm_batches(corpus, args.batch, args.seq, seed=1,
                              extras=extras),
                   args.batch * args.seq, device=torch.device(args.device))
    return run if mesh is None else shard(run, mesh)


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
    its manifest.  Over a mesh every rank gathers the shards and rank 0
    writes (the others return {})."""
    full = _local(combine_lora(run.backbone, run.adapters))  # every rank
    if not _rank0():
        return {}
    n = save_checkpoint(path, reference_tree(full, run.cfg), {"arch": arch})
    manifest = checkpoint_manifest(full)
    print(f"saved {n / 1e6:.1f} MB -> {path}.npz ; {manifest}")
    return manifest


def main(argv: Optional[List[str]] = None) -> TrainRun:
    import torch.distributed as dist
    args = build_parser().parse_args(argv)
    started = bool(args.mesh) and not dist.is_initialized()
    try:
        run = train(setup(args), args.steps, log_fn=_log)
        if args.ckpt:
            save(run, args.ckpt, args.arch)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return run


if __name__ == "__main__":
    main()
