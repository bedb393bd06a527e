"""The training step: loss, gradient accumulation, optimizer update
(counterpart of ``merlin_tpu/train/step.py``).

Batches enter as uint8 images and int32 tokens; the images are normalized
on the device. Microbatches for gradient accumulation arrive stacked on a
leading axis and run one after another, each with its own backward; their
gradients are summed in the parameters' ``.grad`` and scaled by
1 / accum before the update, the JAX step's order. PyTorch runs eagerly,
so nothing here is compiled.

On a mesh (``mesh=``) each rank takes the rows of its (data, fsdp)
coordinate (:func:`local_rows`, ``step.py:91-95``'s batch sharding), and
the loss is JAX's GLOBAL mean over the microbatch's valid tokens: each rank
divides its sum by the count all-reduced over (data, fsdp), and the sum of
those shares over the ranks is the global mean (averaging per-rank means
would weigh a rank's tokens by its own count). FSDP2 averages gradients
over (data, fsdp), so each share is differentiated times data x fsdp. Ranks of one (seq,
tensor) group hold the same rows and compute the same loss.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from merlin_tpu_torch.core.mesh import all_reduce_dp, dp_rank, dp_size
from merlin_tpu_torch.core.parallel import local
from merlin_tpu_torch.ops.image_ops import normalize as normalize_images
from merlin_tpu_torch.train.optimizer import Optimizer, path_names


def make_loss_fn(model: nn.Module, *, use_packing_segments: bool = False,
                 loss_parts: bool = False):
    """batch (one microbatch) -> scalar loss, or with ``loss_parts`` its
    (sum, valid-token count). Segment ids are the attention mask (0 on
    padding), or the packing segment ids."""
    def loss_fn(batch: Dict[str, torch.Tensor]):
        seg = (batch["segment_ids"] if use_packing_segments
               else batch["attention_mask"])
        images = batch.get("images")
        if images is not None:
            images = normalize_images(images)
        kw = {"loss_parts": True} if loss_parts else {}
        _, _, loss = model(batch["input_ids"], images=images,
                           segment_ids=seg.to(torch.int32),
                           labels=batch["labels"], **kw)
        return loss

    return loss_fn


def row_shards(mesh) -> Tuple[int, int]:
    """(k, i): the rows a rank is handed split into k parts, of which it
    takes part i. The rows are one node's (the pipeline reads one stream a
    node, ``LOCAL_WORLD_SIZE`` ranks), so k is the number of (data, fsdp)
    coordinates on a node: the mesh lays ranks out data-major, tensor
    innermost."""
    world = dist.get_world_size()
    nodes = max(world // int(os.environ.get("LOCAL_WORLD_SIZE", world)), 1)
    n = dp_size(mesh)
    if n % nodes:
        raise ValueError(f"{nodes} nodes do not split the {n} (data, fsdp) "
                         f"coordinates evenly")
    k = n // nodes
    return k, dp_rank(mesh) % k


def local_rows(batch: Dict[str, torch.Tensor], shards: int, index: int
               ) -> Dict[str, torch.Tensor]:
    """Part ``index`` of ``shards`` of every leaf's row axis (axis 1 of the
    stacked (accum, rows, ...) leaves). Rows the mesh does not divide
    raise: JAX's GSPMD would gather them instead."""
    out = {}
    for key, x in batch.items():
        rows = x.shape[1]
        if rows % shards:
            raise ValueError(f"{key}: {rows} rows do not split over "
                             f"{shards} (data, fsdp) shards")
        n = rows // shards
        out[key] = x[:, index * n:(index + 1) * n]
    return out


def stop_frozen_params(model: nn.Module, trainable_fn: Callable) -> None:
    """``requires_grad_(False)`` on every parameter ``trainable_fn(path)``
    rejects: the torch form of the JAX step's ``stop_gradient``, so the
    frozen backward cone is never computed."""
    for name, param in model.named_parameters():
        param.requires_grad_(bool(trainable_fn(path_names(name))))


def make_train_step(model: nn.Module, optimizer: Optimizer, *,
                    use_packing_segments: bool = False,
                    mesh=None) -> Callable:
    """Returns ``train_step(batch) -> metrics``. ``batch`` leaves are shaped
    (accum, micro_batch, ...); gradients are averaged over the microbatches.
    Metrics: ``loss``, ``grad_norm`` (before clipping) and
    ``update_norm``, as 0-d tensors. The optimizer's parameters must be the
    model's trainable ones. On a ``mesh`` the batch is the node's rows
    (every rank of a node is handed the same) and the model is placed
    (:mod:`merlin_tpu_torch.core.parallel`)."""
    loss_fn = make_loss_fn(model, use_packing_segments=use_packing_segments,
                           loss_parts=mesh is not None)
    params = optimizer.params

    def global_loss(micro):
        """This rank's share of the global mean: its sum over the count
        of valid tokens summed over (data, fsdp); the sum over those
        ranks of the shares is the global mean."""
        total, count = loss_fn(micro)
        count = all_reduce_dp(count.detach().clone(), mesh)
        return total / count.clamp_min(1)

    # FSDP2 divides the gradients it reduces by data x fsdp: the share is
    # differentiated at that scale, so the average is the sum
    grad_scale = float(dp_size(mesh)) if mesh is not None else 1.0

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if mesh is not None:
            batch = local_rows(batch, *row_shards(mesh))
        n_accum = batch["input_ids"].shape[0]
        for p in params.values():
            p.grad = None
        loss_sum = None
        for i in range(n_accum):
            micro = {k: v[i] for k, v in batch.items()}
            loss = loss_fn(micro) if mesh is None else global_loss(micro)
            (loss * grad_scale if mesh is not None else loss).backward()
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
        if mesh is not None:
            loss_sum = all_reduce_dp(loss_sum.clone(), mesh)
        inv = 1.0 / n_accum
        # a parameter the forward never reached has a zero gradient, as in
        # JAX, so Adam and the decay still see it
        grads = {n: local(p.grad) if p.grad is not None
                 else torch.zeros_like(local(p))
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
