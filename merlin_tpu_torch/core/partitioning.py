"""Logical-axis partitioning rules (counterpart of
``merlin_tpu/core/partitioning.py``).

Modules annotate their parameters with *logical* axis names (``embed``,
``heads``, ``mlp``, ``vocab`` ...; each module's ``param_axes``) and this
module maps them to *physical* mesh axes (``data``/``fsdp``/``seq``/
``tensor``) through one table:

  * FSDP = shard ``embed`` on the fsdp axis (FSDP2, gathered on use)
  * TP   = shard ``heads``/``mlp``/``vocab`` on the tensor axis
  * DP   = shard ``batch`` on (data, fsdp)
  * SP   = shard ``act_seq`` on the seq axis

Two readings of the table, as in the JAX package (trap C41):
:func:`spec_for_logical` reads ``dict(rules)`` (the LAST duplicate of a name
wins, and one mesh axis may serve two dims), while
:func:`logical_to_mesh_axes`, behind :func:`sharding_for_tree`, is flax's
resolution: rules are taken in table order, a rule binds the first dim of
its name if that dim is still unassigned and none of its mesh axes is
already used by another dim (the FIRST match wins). A name on two dims of
one parameter is an error there, as in flax.

A placement is the DTensor form of a spec: one ``Shard(dim)`` or
``Replicate()`` per mesh dim.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from merlin_tpu_torch.core.mesh import MESH_AXES

# (logical axis name, physical mesh axis (or tuple, or None=replicated))
DEFAULT_LOGICAL_AXIS_RULES: Tuple[Tuple[str, Any], ...] = (
    # --- parameter axes ---
    ("embed", "fsdp"),          # row dim of most weights: FSDP shard
    ("heads", "tensor"),        # attention heads: TP shard
    ("kv", None),               # per-head dim: never sharded
    ("mlp", "tensor"),          # MLP hidden: TP shard
    ("vocab", "tensor"),        # embedding/lm_head vocab dim: TP shard
    ("norm", None),
    ("layers", None),           # scan_layers stacked-layer dim: replicated
    # vision tower
    ("vit_embed", "fsdp"),
    ("vit_mlp", "tensor"),
    ("vit_heads", "tensor"),
    ("vit_patches", None),
    ("conv_hw", None),
    ("conv_in", None),
    ("conv_out", "tensor"),
    # --- activation axes ---
    ("batch", ("data", "fsdp")),
    ("act_seq", "seq"),
    ("act_embed", None),
    ("act_heads", "tensor"),
    ("act_mlp", "tensor"),
    ("act_vocab", "tensor"),
    # --- optimizer/expert ---
    ("expert", "expert"),
)

Spec = Tuple[Any, ...]


def logical_axis_rules(overrides: Optional[Sequence[Tuple[str, Any]]] = None):
    """Default rules with optional overrides prepended (first match wins)."""
    if not overrides:
        return DEFAULT_LOGICAL_AXIS_RULES
    return tuple(overrides) + DEFAULT_LOGICAL_AXIS_RULES


def spec_for_logical(logical_axes: Sequence[Optional[str]],
                     rules=DEFAULT_LOGICAL_AXIS_RULES) -> Spec:
    """(logical names per dim) -> mesh axes per dim via ``dict(rules)``."""
    table = dict(rules)
    return tuple(table.get(name) if name is not None else None
                 for name in logical_axes)


def _mesh_names(assignment) -> set:
    if assignment is None:
        return set()
    if isinstance(assignment, str):
        return {assignment}
    return {a for a in assignment if a is not None}


_UNASSIGNED = object()


def logical_to_mesh_axes(logical_axes: Optional[Sequence[Optional[str]]],
                         rules=DEFAULT_LOGICAL_AXIS_RULES) -> Optional[Spec]:
    """flax's ``logical_to_mesh_axes``: first match wins, a mesh axis serves
    at most one dim, unmatched dims are replicated (None)."""
    if logical_axes is None:
        return None
    logical_axes = tuple(logical_axes)
    counts = collections.Counter(logical_axes)
    dups = tuple(k for k, v in counts.items() if v > 1 and isinstance(k, str))
    if dups:
        raise ValueError(
            f"Unsupported: Dimensions {dups} occur more than once in array "
            f"names.")
    result = [_UNASSIGNED if isinstance(n, str) else n for n in logical_axes]
    for name, mesh_axes in rules:
        if name in logical_axes:
            pos = logical_axes.index(name)
            used = set()
            for r in result:
                if r is not _UNASSIGNED:
                    used |= _mesh_names(r)
            if not (_mesh_names(mesh_axes) & used) \
                    and result[pos] is _UNASSIGNED:
                result[pos] = mesh_axes
    return tuple(None if r is _UNASSIGNED else r for r in result)


def placements_for_spec(spec: Optional[Spec], mesh_dim_names=MESH_AXES):
    """mesh axes per tensor dim -> one placement per mesh dim."""
    names = list(mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, axes in enumerate(spec or ()):
        # a dim over several mesh axes ("data", "fsdp") lists them major
        # first, the mesh's own order
        for name in ((axes,) if isinstance(axes, str) else (axes or ())):
            if name is None:
                continue
            if name not in names:
                raise ValueError(f"mesh axis {name!r} is not in the mesh "
                                 f"{tuple(names)}")
            i = names.index(name)
            if isinstance(out[i], Shard):
                raise ValueError(f"mesh axis {name!r} shards two dims")
            out[i] = Shard(dim)
    return tuple(out)


def sharding_for_tree(logical_tree: Mapping[str, Optional[Sequence]],
                      mesh=None, rules=DEFAULT_LOGICAL_AXIS_RULES, *,
                      strict: bool = True) -> Dict[str, tuple]:
    """Parameter name -> placements (one per mesh dim) from each name's
    logical axes (None or () -> replicated), by flax's resolution. ``mesh``
    names the dims (the four axes when None). A name on two dims of one
    parameter (the convolutions' ``conv_hw``) raises, as in flax; with
    ``strict=False`` that parameter is replicated instead."""
    names = tuple(mesh.mesh_dim_names) if mesh is not None else MESH_AXES
    out = {}
    for name, axes in logical_tree.items():
        try:
            spec = logical_to_mesh_axes(axes, rules) if axes else None
        except ValueError:
            if strict:
                raise
            spec = None
        out[name] = placements_for_spec(spec, names)
    return out


def shard_logical(x: torch.Tensor, logical_axes: Sequence[Optional[str]],
                  mesh, rules=DEFAULT_LOGICAL_AXIS_RULES):
    """``x`` (the same on every rank) as a DTensor laid out by the logical
    sharding: the eager form of JAX's sharding constraint (the values do
    not change)."""
    spec = spec_for_logical(logical_axes, rules)
    return distribute_tensor(x, mesh, placements_for_spec(
        spec, mesh.mesh_dim_names))


# ---------------------------------------------------------------------------
# The port's parameters: logical axes by name
# ---------------------------------------------------------------------------

def set_param_axes(module: nn.Module, **axes) -> None:
    """Record the logical axes of ``module``'s own parameters (leaf name ->
    tuple), the port's ``nn.with_logical_partitioning``."""
    own = dict(getattr(module, "param_axes", {}))
    own.update({k: tuple(v) for k, v in axes.items()})
    module.param_axes = own


def logical_axes(model: nn.Module) -> Dict[str, Optional[Tuple]]:
    """Every parameter's name -> its logical axes (None when its module
    gave none, which places it replicated, as flax's unboxed leaves).
    Parameters of a ``scan_layers`` stack (modules marked
    ``stacked_layers``) lead with ``"layers"``, as ``nn.scan``'s
    ``PARTITION_NAME`` adds it."""
    out: Dict[str, Optional[Tuple]] = {}
    for mod_name, module in model.named_modules():
        axes = getattr(module, "param_axes", {})
        lead = ("layers",) if getattr(module, "stacked_layers", False) else ()
        for leaf, _ in module.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            own = axes.get(leaf)
            out[name] = (lead + own) if own is not None else None
    return out
