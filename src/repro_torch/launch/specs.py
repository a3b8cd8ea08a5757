"""Abstract input specs for every (architecture x input shape), and the
per-shape steps (port of ``repro/launch/specs.py``).

The reference's specs are ``jax.ShapeDtypeStruct``s from ``eval_shape``;
the port's are tensors on the meta device: names, shapes and dtypes, no
storage, nothing drawn (``transformer.init_params(device="meta")``).

The four input shapes lower different steps:
  train_4k    -> LoRA train_step   (B=256, T=4096)
  prefill_32k -> prefill_step      (B=32,  T=32768)
  decode_32k  -> serve_step, 1 token (B=128, KV len 32768)
  long_500k   -> serve_step, 1 token (B=1, context 524288; sub-quadratic
                 archs only: dense archs run their sliding-window variant)

Modality frontends are stubs, as in the reference: Whisper gets (B, 1500,
D) frame embeddings, PaliGemma (B, 256, D) patch embeddings.  The steps
run the port's own functions: ``training/train.py::make_lora_train_step``
(remat), ``transformer.forward`` on a fresh ring cache (the flash kernel)
and ``transformer.decode_step`` (the ring-decode kernel).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.lora import partition_lora
from repro_torch.models import transformer as tf
from repro_torch.models.cache import effective_cache_len
from repro_torch.models.config import ModelConfig
from repro_torch.training.adamw import AdamW, constant_schedule
from repro_torch.training.train import make_lora_train_step

META = torch.device("meta")

INPUT_SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": dict(seq_len=4096, global_batch=256),
    "prefill_32k": dict(seq_len=32768, global_batch=32),
    "decode_32k": dict(seq_len=32768, global_batch=128),
    "long_500k": dict(seq_len=524288, global_batch=1),
}


def adapt_config(cfg: ModelConfig, shape_name: str) -> Optional[ModelConfig]:
    """Shape-specific config; None skips the combination.  long_500k needs
    sub-quadratic decode: SSM/hybrid and sliding-window archs run natively,
    dense archs run their sliding-window variant, Whisper (full-attention
    encoder-decoder) is skipped."""
    if shape_name != "long_500k":
        return cfg
    if cfg.family == "audio":
        return None
    if cfg.is_subquadratic:
        return cfg
    return cfg.with_(sliding_window=cfg.long_context_window)


def abstract_params(cfg: ModelConfig, lora_adapters: Optional[int] = None,
                    device=META):
    """The model's params on ``device`` (meta: no storage); one adapter
    with (D, r) / (r, O) leaves by default, the reference's
    ``init_params(lora_adapters=None)``."""
    return tf.init_params(cfg, None, device, lora_adapters=lora_adapters,
                          lora_b_scale=0.0)


def batch_inputs(cfg: ModelConfig, B: int, T: int,
                 device=META) -> Dict[str, torch.Tensor]:
    """Training/prefill batch with the stub modality embeddings."""
    extra: Dict[str, torch.Tensor] = {}
    t_text = T
    dt = cfg.torch_dtype
    if cfg.family == "vlm":
        t_text = max(T - cfg.num_image_tokens, 16)
        extra["embeds"] = torch.empty((B, cfg.num_image_tokens, cfg.d_model),
                                      dtype=dt, device=device)
    if cfg.family == "audio":
        extra["frame_embeds"] = torch.empty((B, cfg.encoder_seq, cfg.d_model),
                                            dtype=dt, device=device)
    return {"tokens": torch.empty((B, t_text), dtype=torch.int32,
                                  device=device), **extra}


def abstract_cache(cfg: ModelConfig, B: int, context: int, device=META):
    return tf.init_cache(cfg, B, context, device=device)


@dataclasses.dataclass
class StepSpec:
    """A unit the dry run executes: callable + abstract args (in order).
    The prefill and serve steps update their cache in place (the
    reference donates it)."""
    name: str
    fn: Callable
    args: Tuple[Any, ...]


def prefill_fn(cfg: ModelConfig) -> Callable:
    """prefill_step(params, batch, cache) -> (last logits (B, V), cache):
    a fresh ring filled at positions [0, T)."""

    def prefill_step(params, batch, cache):
        logits, new_cache = tf.forward(
            params, cfg, batch["tokens"], cache=cache,
            embeds=batch.get("embeds"),
            frame_embeds=batch.get("frame_embeds"), last_only=True)
        return logits[:, -1], new_cache

    return prefill_step


def serve_fn(cfg: ModelConfig) -> Callable:
    """serve_step(params, token, cache, pos) -> (logits (B, V), cache)."""

    def serve_step(params, token, cache, pos):
        return tf.decode_step(params, cfg, token, cache, pos)

    return serve_step


def build_step(cfg: ModelConfig, shape_name: str) -> Optional[StepSpec]:
    sh = INPUT_SHAPES[shape_name]
    B, T = sh["global_batch"], sh["seq_len"]
    cfg = adapt_config(cfg, shape_name)
    if cfg is None:
        return None

    if shape_name == "train_4k":
        backbone, adapters = partition_lora(abstract_params(cfg))
        opt = AdamW(lr=constant_schedule(1e-4))
        batch = batch_inputs(cfg, B, T)
        batch["labels"] = torch.empty_like(batch["tokens"])
        return StepSpec("train_step",
                        make_lora_train_step(cfg, opt, remat=True),
                        (backbone, adapters, opt.init(adapters), batch))

    params = abstract_params(cfg)
    cache = abstract_cache(cfg, B, effective_cache_len(cfg, T))
    if shape_name == "prefill_32k":
        return StepSpec("prefill_step", prefill_fn(cfg),
                        (params, batch_inputs(cfg, B, T), cache))

    # decode shapes: ONE new token against a seq_len-deep context
    token = torch.empty((B,), dtype=torch.int32, device=META)
    pos = torch.empty((), dtype=torch.int32, device=META)
    return StepSpec("serve_step", serve_fn(cfg), (params, token, cache, pos))
