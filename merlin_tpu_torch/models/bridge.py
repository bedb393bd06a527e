"""Parameters for the port's modules.

  * :func:`params_from_flax` turns a JAX-package param tree (nested dicts
    of numpy arrays) into a ``state_dict``: each entry is named by its flax
    path joined with '.', and keeps the flax layout, because the port's
    modules use the flax names and layouts. It is a rename, not a relayout.
  * :func:`init_params` fills every parameter with N(0, 1) * std directly on
    the device in the target dtype, as the JAX package's
    ``bench.materialize_params`` does for ``entry()``. Build the module under
    ``torch.device("meta")`` first so that no host copy ever exists: a
    Vicuna-7B is 13.5 GB in bf16 and twice that in f32. Serving keeps the
    parameters frozen (``requires_grad=False``); training asks for
    trainable f32 parameters (``Policy.param_dtype``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping[str, Any], prefix: str, out: Dict[str, Any]):
    for key, val in tree.items():
        name = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, Mapping):
            _flatten(val, name, out)
        else:
            out[name] = val
    return out


def params_from_flax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax param tree of array leaves -> ``state_dict`` for the port."""
    return {name: torch.from_numpy(np.array(val, copy=True))
            for name, val in _flatten(tree, "", {}).items()}


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator,
                std: float = 0.02, dtype: torch.dtype = torch.bfloat16,
                device: Union[str, torch.device] = "cuda",
                requires_grad: bool = False) -> nn.Module:
    """Replace every parameter of ``module`` by N(0, 1) * std drawn with
    ``generator`` (which must live on ``device``), created on ``device`` in
    ``dtype`` (f32, ``DEFAULT_POLICY.param_dtype``, to train) with
    ``requires_grad``. Leaves are drawn one at a time in
    ``named_parameters`` order, so the peak is the model plus one leaf.
    Returns the module."""
    for name, param in list(module.named_parameters()):
        owner = module.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        fresh = torch.empty(param.shape, dtype=dtype, device=device)
        fresh.normal_(0.0, 1.0, generator=generator).mul_(std)
        setattr(owner, leaf, nn.Parameter(fresh,
                                          requires_grad=requires_grad))
    return module
