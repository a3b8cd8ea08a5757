"""Training steps (port of ``repro/training/train.py``): LoRA fine-tuning
over a frozen shared backbone (the paper's setting) and full-model
training for small architectures.

A step runs the cache-free ``transformer.forward_train`` eagerly, with
``torch.autograd.grad`` over the leaves it trains: no kernel (the
kernels have no backward and refuse a grad-requiring input on the card),
no ``torch.compile``.  ``make_lora_train_step`` differentiates ONLY the
adapter leaves: the backbone's tensors are used as they are, never
marked as requiring grad, so autograd keeps no weight gradient of theirs
and the optimizer state is O(adapter).  Gradients are returned, never
accumulated into ``.grad``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.core.lora import (_zip_map, combine_lora, partition_lora,
                                   tree_leaves)
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.training.adamw import AdamW, AdamWState, cosine_schedule

Params = Dict[str, Any]


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy in float32.  logits (B, T, V); labels
    (B, T); ``mask`` (B, T) weights the positions (the mean over its
    sum, at least 1)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is None:
        return -torch.mean(ll)
    mask = mask.to(ll.dtype)
    return -torch.sum(ll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def batch_to(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays (``data/pipeline.py::lm_batches``) or
    tensors, as tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict, *,
            aux_weight: float = 0.01, remat: bool = True):
    """(cross-entropy + ``aux_weight`` x the MoE aux loss, {"ce", "aux"})
    of a batch of tensors {"tokens", "labels"[, "mask", "embeds",
    "frame_embeds"]}."""
    logits, aux = tf.forward_train(
        params, cfg, batch["tokens"], embeds=batch.get("embeds"),
        frame_embeds=batch.get("frame_embeds"), remat=remat)
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _value_and_grad(cfg: ModelConfig, tree: Any, build, batch: Dict,
                    remat: bool):
    """Loss, metrics and the gradient tree of ``tree``'s leaves, where
    ``build(leaves_tree)`` gives the model's params.  The leaves are
    detached aliases marked as requiring grad; the caller's tensors are
    left as they are."""
    live = _zip_map(lambda x: None if x is None
                    else x.detach().requires_grad_(True), tree)
    leaves = tree_leaves(live)
    with torch.enable_grad():
        loss, metrics = loss_fn(build(live), cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_id = {id(x): torch.zeros_like(x) if g is None else _placed_as(g, x)
             for x, g in zip(leaves, grads)}
    gtree = _zip_map(lambda x: None if x is None else by_id[id(x)], live)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, gtree


def _placed_as(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A DTensor leaf's gradient placed as the leaf is (a partial sum over
    a mesh dim is reduced there): the optimizer then updates each shard,
    or each replica, with the whole gradient."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and list(g.placements) != list(x.placements):
        return g.redistribute(x.device_mesh, x.placements)
    return g


def make_lora_train_step(cfg: ModelConfig, opt: AdamW, *,
                         remat: bool = True):
    """Returns train_step(backbone, adapters, opt_state, batch) ->
    (new adapters, new opt_state, metrics {"ce", "aux", "loss",
    "grad_norm"}): gradients on the adapters only."""

    def train_step(backbone: Params, adapters: Params,
                   opt_state: AdamWState, batch: Dict):
        batch = batch_to(batch, backbone["embed"].device)
        loss, metrics, grads = _value_and_grad(
            cfg, adapters, lambda ad: combine_lora(backbone, ad), batch,
            remat)
        new_ad, new_opt = opt.update(grads, opt_state, adapters)
        metrics = dict(metrics, loss=loss, grad_norm=_global_norm(grads))
        return new_ad, new_opt, metrics

    return train_step


def make_full_train_step(cfg: ModelConfig, opt: AdamW, *,
                         remat: bool = True):
    """Returns train_step(params, opt_state, batch) -> (new params, new
    opt_state, metrics): gradients on every leaf."""

    def train_step(params: Params, opt_state: AdamWState, batch: Dict):
        batch = batch_to(batch, params["embed"].device)
        loss, metrics, grads = _value_and_grad(cfg, params, lambda p: p,
                                               batch, remat)
        new_p, new_opt = opt.update(grads, opt_state, params)
        metrics = dict(metrics, loss=loss, grad_norm=_global_norm(grads))
        return new_p, new_opt, metrics

    return train_step


def _global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def train_loop(cfg: ModelConfig, params: Params, data_iter, *,
               steps: int, opt: Optional[AdamW] = None,
               lora_only: bool = True, log_every: int = 10,
               log_fn=print):
    """Single-device training loop used by the examples.  Returns
    (trained params, the loss of every step)."""
    opt = opt or AdamW(lr=cosine_schedule(3e-4, min(20, steps // 10 + 1),
                                          steps))
    history = []

    def log(i, m):
        history.append(float(m["loss"]))
        if i % log_every == 0:
            log_fn(f"step {i:5d} loss {float(m['loss']):.4f} "
                   f"gnorm {float(m['grad_norm']):.3f}")

    if lora_only:
        backbone, adapters = partition_lora(params)
        opt_state = opt.init(adapters)
        step_fn = make_lora_train_step(cfg, opt)
        for i in range(steps):
            adapters, opt_state, m = step_fn(backbone, adapters, opt_state,
                                             next(data_iter))
            log(i, m)
        return combine_lora(backbone, adapters), history
    opt_state = opt.init(params)
    step_fn = make_full_train_step(cfg, opt)
    for i in range(steps):
        params, opt_state, m = step_fn(params, opt_state, next(data_iter))
        log(i, m)
    return params, history
