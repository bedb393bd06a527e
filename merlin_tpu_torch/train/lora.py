"""Functional LoRA (counterpart of ``merlin_tpu/train/lora.py``).

LoRA lives at the parameter level, as in the JAX package: a dict of (a, b)
factors for every targeted kernel, keyed by the kernel's ``state_dict``
name (the flax path joined with '.'). The forward merges
``W + (alpha/r) * a @ b`` into a dict of tensors that
``torch.func.functional_call`` runs the model on, so gradients reach only
the factors and the optimizer state is rank-r too.

Targets follow the reference's ``find_all_linear_names``: every LM linear
but the head, never the tower or the projector. Like JAX's pattern, the
default one matches the loop decoder's ``lm.layers_<i>.`` names only, so a
``scan_layers`` stack has no target.

Nothing in the training loop reads this module: JAX's trainer drops
``lora_enable`` and the port's ``Trainer`` refuses it (trap C30).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from merlin_tpu_torch.train.step import make_loss_fn

DEFAULT_TARGET_RE = re.compile(
    r"^lm\.layers_\d+\.(attn\.(q|k|v|o)_proj|mlp\.(gate|up|down)_proj"
    r"|mlp\.fc[12])\.kernel$")

Factors = Dict[str, Dict[str, torch.Tensor]]


def find_lora_targets(params: Mapping[str, torch.Tensor],
                      target_re=DEFAULT_TARGET_RE) -> List[str]:
    """The kernel names to adapt, sorted."""
    return sorted(name for name, leaf in params.items()
                  if target_re.match(name) and leaf.dim() >= 2)


def init_lora_params(params: Mapping[str, torch.Tensor], *, rank: int = 64,
                     generator: Optional[torch.Generator] = None,
                     target_re=DEFAULT_TARGET_RE) -> Factors:
    """{kernel name: {"a": (in, r), "b": (r, out)}} in f32 on the kernel's
    device: a ~ N(0, 1) / r drawn from ``generator`` (which lives on that
    device; seed 0 when None) in name order, b zero, so the adapted model
    starts exactly at the base model."""
    lora: Factors = {}
    for name in find_lora_targets(params, target_re):
        leaf = params[name]
        if generator is None:
            generator = torch.Generator(device=leaf.device).manual_seed(0)
        in_dim, out_dim = leaf.shape[0], leaf[0].numel()
        a = torch.randn((in_dim, rank), generator=generator,
                        device=leaf.device, dtype=torch.float32)
        lora[name] = {"a": a * (1.0 / rank),
                      "b": torch.zeros((rank, out_dim), device=leaf.device)}
    return lora


def merge_lora(params: Mapping[str, torch.Tensor], lora: Factors, *,
               rank: int = 64, alpha: float = 16.0) -> Dict[str, torch.Tensor]:
    """``params`` with each adapted kernel replaced by W + (alpha/rank) *
    a @ b reshaped to W and cast to W's dtype before the add, as JAX does;
    the other entries are the same tensors."""
    scale = alpha / rank
    out = dict(params)
    for name, entry in lora.items():
        leaf = params.get(name)
        if leaf is None:
            continue
        delta = (entry["a"] @ entry["b"]).reshape(leaf.shape) * scale
        out[name] = leaf + delta.to(leaf.dtype)
    return out


def make_lora_loss_fn(model: nn.Module,
                      base_params: Mapping[str, torch.Tensor], *, rank: int,
                      alpha: float, use_packing_segments: bool = False):
    """``loss(lora_params, batch)``: :func:`~merlin_tpu_torch.train.step.
    make_loss_fn`'s loss of ``model`` run on the merged parameters; the
    base (a ``state_dict``) is closed over and gets no gradient."""
    def loss_fn(lora_params: Factors, batch: Dict[str, torch.Tensor]):
        merged = merge_lora(base_params, lora_params, rank=rank, alpha=alpha)

        def call(*args, **kwargs):
            return torch.func.functional_call(model, merged, args, kwargs)

        return make_loss_fn(call, use_packing_segments=use_packing_segments)(
            batch)

    return loss_fn


def split_lora_state(params: Mapping[str, torch.Tensor], lora: Factors
                     ) -> Tuple[Factors, Dict[str, Any]]:
    """(the factors, the other trainables) for the reference's split save
    (train.py:64-77): the projector's entries, by their names under
    ``projector.``, or None when the model has none."""
    proj = {name[len("projector."):]: t for name, t in params.items()
            if name.startswith("projector.")}
    return dict(lora), {"projector": proj or None}
