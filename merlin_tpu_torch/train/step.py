"""The training step: loss, gradient accumulation, optimizer update
(counterpart of ``merlin_tpu/train/step.py``).

Batches enter as uint8 images and int32 tokens; the images are normalized
on the device. Microbatches for gradient accumulation arrive stacked on a
leading axis and run one after another, each with its own backward; their
gradients are summed in the parameters' ``.grad`` and scaled by
1 / accum before the update, the JAX step's order. PyTorch runs eagerly,
so nothing here is compiled.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from merlin_tpu_torch.ops.image_ops import normalize as normalize_images
from merlin_tpu_torch.train.optimizer import Optimizer, path_names


def make_loss_fn(model: nn.Module, *, use_packing_segments: bool = False):
    """batch (one microbatch) -> scalar loss. Segment ids are the attention
    mask (0 on padding), or the packing segment ids."""
    def loss_fn(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        seg = (batch["segment_ids"] if use_packing_segments
               else batch["attention_mask"])
        images = batch.get("images")
        if images is not None:
            images = normalize_images(images)
        _, _, loss = model(batch["input_ids"], images=images,
                           segment_ids=seg.to(torch.int32),
                           labels=batch["labels"])
        return loss

    return loss_fn


def stop_frozen_params(model: nn.Module, trainable_fn: Callable) -> None:
    """``requires_grad_(False)`` on every parameter ``trainable_fn(path)``
    rejects: the torch form of the JAX step's ``stop_gradient``, so the
    frozen backward cone is never computed."""
    for name, param in model.named_parameters():
        param.requires_grad_(bool(trainable_fn(path_names(name))))


def make_train_step(model: nn.Module, optimizer: Optimizer, *,
                    use_packing_segments: bool = False) -> Callable:
    """Returns ``train_step(batch) -> metrics``. ``batch`` leaves are shaped
    (accum, micro_batch, ...); gradients are averaged over the microbatches.
    Metrics: ``loss``, ``grad_norm`` (before clipping) and
    ``update_norm``, as 0-d tensors. The optimizer's parameters must be the
    model's trainable ones."""
    loss_fn = make_loss_fn(model, use_packing_segments=use_packing_segments)
    params = optimizer.params

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        n_accum = batch["input_ids"].shape[0]
        for p in params.values():
            p.grad = None
        loss_sum = None
        for i in range(n_accum):
            loss = loss_fn({k: v[i] for k, v in batch.items()})
            loss.backward()
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
        inv = 1.0 / n_accum
        # a parameter the forward never reached has a zero gradient, as in
        # JAX, so Adam and the decay still see it
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        torch._foreach_mul_(list(grads.values()), inv)
        metrics = optimizer.step(grads)
        metrics["loss"] = loss_sum * inv
        for p in params.values():
            p.grad = None
        return metrics

    return train_step


def stack_microbatches(batch: Dict[str, Any], grad_accum: int):
    """(accum*micro, ...) host batch -> (accum, micro, ...) leaves."""
    def reshape(x):
        b = x.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch of {b} does not split into "
                             f"{grad_accum} microbatches")
        return x.reshape((grad_accum, b // grad_accum) + tuple(x.shape[1:]))

    return {k: reshape(np.asarray(v) if not torch.is_tensor(v) else v)
            for k, v in batch.items()}
