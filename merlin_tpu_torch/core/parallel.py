"""Placing a model on a mesh: tensor parallelism by hand, FSDP2 over
(data, fsdp), and the collectives both need.

The rules (:mod:`merlin_tpu_torch.core.partitioning`) give every parameter
one placement per mesh dim. The port realizes them in two steps:

  * ``tensor``: :func:`apply_tensor_parallel` cuts each parameter the rules
    shard on ``tensor`` down to this rank's slice, IN PLACE, as a plain
    tensor: the modules and the kernels take local tensors (the heads of
    this rank, its MLP columns, its vocabulary rows), never DTensors.
    Column-parallel products (the rules shard an OUTPUT dim: q/k/v, the
    MLP's up projections, the LM head) enter through :func:`copy_to_group`
    (identity; all-reduce of the gradient), row-parallel ones (an INPUT
    dim: o_proj, the MLP's down projection) leave through
    :func:`reduce_from_group` (all-reduce of the f32 product before the
    bias and the one rounding; identity in the backward). The
    vocabulary-parallel embedding zeroes the ids of other ranks and
    all-reduces; the LM head's logits are gathered (:func:`gather_from_group`,
    whose backward hands each rank its own slice). The local head count is
    read from the weights, the ALiBi slopes sliced per rank. Tensor
    parallelism covers the decoder (attention, MLP, embeddings, head) and
    the ViT blocks; the other tower kinds, the projectors and the patch
    embeddings run replicated over ``tensor`` (their rules' ``conv_out``/
    ``heads`` dims are left whole).
  * ``data``/``fsdp``: :func:`apply_fsdp` wraps the tower, the projector
    and the root (the LM) with FSDP2 ``fully_shard`` on the (data, fsdp)
    sub-mesh: HSDP, data replicates and fsdp shards, each parameter along
    its rules' fsdp dim (dim 0 where the rules give none: FSDP2 shards
    every parameter). The parameters become DTensors on that sub-mesh.
    FSDP2 averages the gradients over (data, fsdp); the step scales each
    rank's share of the global mean by data x fsdp before the backward, so
    the average is the sum of the shares
    (:mod:`merlin_tpu_torch.train.step`).

:class:`ParallelInfo` keeps what the rest needs: the tensor dims, and the
maps between a full tensor and this rank's local part (checkpoints, the
embedding row mask) and the norm weights of the global gradient norm.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from merlin_tpu_torch.core.mesh import (
    AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, MESH_AXES, axis_rank, axis_size)
from merlin_tpu_torch.core.partitioning import (
    DEFAULT_LOGICAL_AXIS_RULES, logical_axes, sharding_for_tree)


# ---------------------------------------------------------------------------
# Differentiable collectives (a group of None is the identity)
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim = group, dim
        ctx.rank = dist.get_rank(group)
        parts = [torch.empty_like(x.contiguous()) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        return g.chunk(n, dim=ctx.dim)[ctx.rank].contiguous(), None, None


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        n = dist.get_world_size(group)
        ctx.group, ctx.dim = group, dim
        return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        parts = [torch.empty_like(g.contiguous()) for _ in range(n)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=ctx.dim), None, None


def copy_to_group(x, group):
    """Identity; the backward all-reduces the gradient over ``group``."""
    return x if group is None else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    """All-reduce (sum) over ``group``; the backward is the identity."""
    return x if group is None else _ReduceFromGroup.apply(x, group)


def gather_from_group(x, group, dim: int = -1):
    """Concatenate the ranks' ``x`` along ``dim``; the backward hands each
    rank its own slice of the gradient (not a sum over the group)."""
    if group is None:
        return x
    return _GatherFromGroup.apply(x, group, dim % x.dim())


def split_to_group(x, group, dim: int):
    """This rank's chunk of ``x`` along ``dim``; the backward all-gathers
    the chunks' gradients."""
    if group is None:
        return x
    return _SplitToGroup.apply(x, group, dim % x.dim())


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParallelInfo:
    mesh: object
    placements: Dict[str, tuple]
    tp_dims: Dict[str, int]          # parameter -> dim cut over "tensor"
    tp_group: object = None
    tp_rank: int = 0
    tp_size: int = 1

    # --- full <-> local ---------------------------------------------------
    def tp_slice(self, name: str, full: torch.Tensor) -> torch.Tensor:
        dim = self.tp_dims.get(name)
        if dim is None:
            return full
        return full.chunk(self.tp_size, dim=dim)[self.tp_rank]

    def local_part(self, name: str, full: torch.Tensor,
                   param: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The part of the FULL tensor ``full`` (the shape of parameter
        ``name`` before any cut) this rank holds: its tensor slice, then
        its FSDP shard when ``param`` is a DTensor."""
        t = self.tp_slice(name, full)
        if isinstance(param, DTensor):
            mesh = param.device_mesh
            coord = mesh.get_coordinate()
            for i, pl in enumerate(param.placements):
                if isinstance(pl, Shard):
                    t = _padded_chunk(t, mesh.size(i), pl.dim, coord[i])
        return t.contiguous()

    def local_index(self, name: str, dim: int,
                    param: torch.Tensor) -> torch.Tensor:
        """The global indices along ``dim`` of the part of parameter
        ``name`` this rank holds (:meth:`local_part` of an arange)."""
        cut = self.tp_dims.get(name) == dim
        idx = torch.arange(param.shape[dim] * (self.tp_size if cut else 1))
        if cut:
            idx = idx.chunk(self.tp_size)[self.tp_rank]
        if isinstance(param, DTensor):
            mesh = param.device_mesh
            coord = mesh.get_coordinate()
            for i, pl in enumerate(param.placements):
                if isinstance(pl, Shard) and pl.dim == dim:
                    idx = _padded_chunk(idx, mesh.size(i), 0, coord[i])
        return idx

    def full_tensor(self, name: str, local: torch.Tensor,
                    param: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inverse of :meth:`local_part` (a collective: every rank calls
        it). ``local`` is a plain tensor shaped as ``param``'s local part,
        or the DTensor parameter itself."""
        if isinstance(local, DTensor):
            t = local.full_tensor()
        elif isinstance(param, DTensor):
            t = DTensor.from_local(local, param.device_mesh, param.placements,
                                   shape=param.shape,
                                   stride=param.stride()).full_tensor()
        else:
            t = local
        dim = self.tp_dims.get(name)
        if dim is not None:
            parts = [torch.empty_like(t.contiguous())
                     for _ in range(self.tp_size)]
            dist.all_gather(parts, t.contiguous(), group=self.tp_group)
            t = torch.cat(parts, dim=dim)
        return t

    def replication(self, name: str, param: torch.Tensor) -> int:
        """How many ranks hold the same values as this rank's local part
        of ``param`` (the weight of its squares in a global norm)."""
        shards = self.tp_size if name in self.tp_dims else 1
        if isinstance(param, DTensor):
            mesh = param.device_mesh
            for i, pl in enumerate(param.placements):
                if isinstance(pl, Shard):
                    shards *= mesh.size(i)
        return dist.get_world_size() // shards


def _padded_chunk(t, n, dim, i):
    """torch.chunk's i-th piece, empty past the end (FSDP2's uneven rule)."""
    pieces = t.chunk(n, dim=dim)
    if i < len(pieces):
        return pieces[i]
    shape = list(t.shape)
    shape[dim] = 0
    return t.new_empty(shape)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor (the same storage, outside autograd), else
    ``t``."""
    if isinstance(t, DTensor):
        with torch.no_grad():
            return t.to_local()
    return t


def _tp_scopes(model: nn.Module):
    """(module name, module) of every module whose parameters tensor
    parallelism may cut: the DenseGenerals of decoder and ViT blocks and of
    MLPs (column/row pairs), the decoder's embeddings and head."""
    from merlin_tpu_torch.models.decoder import CausalLM, DecoderBlock
    from merlin_tpu_torch.models.layers import (
        DenseGeneral, Embed, GatedMLP, SimpleMLP)
    from merlin_tpu_torch.models.vit import ViTBlock

    seen = set()
    for name, mod in model.named_modules():
        if isinstance(mod, (DecoderBlock, ViTBlock, GatedMLP, SimpleMLP)):
            for sub, m in mod.named_modules():
                if isinstance(m, DenseGeneral) and id(m) not in seen:
                    seen.add(id(m))
                    yield f"{name}.{sub}" if name else sub, m
        elif isinstance(mod, CausalLM):
            for sub in ("embed_tokens", "embed_positions", "lm_head"):
                m = getattr(mod, sub, None)
                if isinstance(m, (DenseGeneral, Embed)):
                    yield f"{name}.{sub}" if name else sub, m
            if hasattr(mod, "lm_head_kernel"):
                yield name, mod


def _tensor_dim(placements) -> Optional[int]:
    pl = placements[MESH_AXES.index(AXIS_TENSOR)]
    return pl.dim if isinstance(pl, Shard) else None


@torch.no_grad()
def apply_tensor_parallel(model: nn.Module, mesh,
                          placements: Optional[Dict[str, tuple]] = None,
                          rules=DEFAULT_LOGICAL_AXIS_RULES) -> ParallelInfo:
    """Cut ``model``'s parameters to this rank's tensor slices (in place)
    and wire the modules' collectives; returns (and stores as
    ``model.parallel_info``) the :class:`ParallelInfo`. ``placements``
    (name -> placements, :func:`sharding_for_tree`) default to the rules
    over the model's logical axes (a parameter whose axes flax refuses,
    the convolutions' repeated ``conv_hw``, replicated). A dim that the
    tensor axis does not divide raises (JAX would gather the operands
    instead)."""
    if placements is None:
        placements = sharding_for_tree(logical_axes(model), mesh, rules,
                                       strict=False)
    tp = axis_size(mesh, AXIS_TENSOR)
    info = ParallelInfo(mesh=mesh, placements=dict(placements), tp_dims={},
                        tp_size=tp, tp_rank=axis_rank(mesh, AXIS_TENSOR),
                        tp_group=mesh.get_group(AXIS_TENSOR)
                        if tp > 1 else None)
    model.parallel_info = info
    if tp == 1:
        return info
    for scope, mod in _tp_scopes(model):
        for leaf, p in mod.named_parameters(recurse=False):
            name = f"{scope}.{leaf}" if scope else leaf
            pl = placements.get(name)
            dim = _tensor_dim(pl) if pl else None
            if dim is None:
                continue
            if p.shape[dim] % tp:
                raise ValueError(
                    f"{name}: dim {dim} of {tuple(p.shape)} does not divide "
                    f"the tensor axis ({tp})")
            p.data = p.data.chunk(tp, dim=dim)[info.tp_rank].contiguous()
            info.tp_dims[name] = dim
    for prefix, mod in model.named_modules():
        hook = getattr(mod, "tensor_parallel_", None)
        if hook is None:
            continue
        pre = f"{prefix}." if prefix else ""
        own = {leaf: info.tp_dims[pre + leaf]
               for leaf, _ in mod.named_parameters(recurse=False)
               if pre + leaf in info.tp_dims}
        hook(own, info, prefix)
    return info


def apply_fsdp(model: nn.Module, info: ParallelInfo) -> None:
    """FSDP2 (HSDP) over the (data, fsdp) sub-mesh: units are the vision
    tower, the projector and the root; each parameter sharded on
    its rules' fsdp dim (dim 0 where the rules give none). FSDP2's
    gradient average over (data, fsdp) stays: the train step scales the
    loss it differentiates to match."""
    from torch.distributed.fsdp import fully_shard

    mesh = info.mesh
    dp_mesh = mesh[AXIS_DATA, AXIS_FSDP]
    fsdp_i = MESH_AXES.index(AXIS_FSDP)
    by_id = {id(p): n for n, p in model.named_parameters()}

    def placement(param):
        name = by_id.get(id(param))
        pl = info.placements.get(name)
        if pl is not None and isinstance(pl[fsdp_i], Shard):
            return Shard(pl[fsdp_i].dim)
        return Shard(0)

    # the LM stays in the root's unit: MMGPT embeds through lm.embed,
    # outside lm.forward, where a unit of its own would still be sharded
    units = [getattr(model, n) for n in ("vision_tower", "projector")
             if isinstance(getattr(model, n, None), nn.Module)]
    for unit in units + [model]:
        fully_shard(unit, mesh=dp_mesh, shard_placement_fn=placement)


def dp_placements(info: ParallelInfo, name: str) -> tuple:
    """The (data, fsdp) placements FSDP2 gives parameter ``name``: the
    data dim replicated, the fsdp dim its rules' Shard (dim 0 where the
    rules give none)."""
    pl = info.placements.get(name)
    fsdp_pl = pl[MESH_AXES.index(AXIS_FSDP)] if pl else None
    return (Replicate(),
            Shard(fsdp_pl.dim) if isinstance(fsdp_pl, Shard) else Shard(0))


def check_placements(model: nn.Module, info: ParallelInfo) -> list:
    """Problems with the trainable parameters' placement: each must be a
    DTensor on the (data, fsdp) sub-mesh with :func:`dp_placements`, and
    cut over ``tensor`` exactly where the rules say. Returns messages
    (empty when all hold)."""
    bad = []
    t_i = MESH_AXES.index(AXIS_TENSOR)
    scoped = {f"{scope}.{leaf}" if scope else leaf
              for scope, mod in _tp_scopes(model)
              for leaf, _ in mod.named_parameters(recurse=False)}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        if not isinstance(p, DTensor):
            bad.append(f"{name}: not a DTensor")
            continue
        if tuple(p.device_mesh.mesh_dim_names) != (AXIS_DATA, AXIS_FSDP):
            bad.append(f"{name}: on mesh {p.device_mesh.mesh_dim_names}")
        if tuple(p.placements) != dp_placements(info, name):
            bad.append(f"{name}: placements {p.placements}")
        pl = info.placements.get(name)
        want = pl[t_i].dim if pl and isinstance(pl[t_i], Shard) else None
        if info.tp_size > 1 and name in scoped \
                and info.tp_dims.get(name) != want:
            bad.append(f"{name}: tensor dim {info.tp_dims.get(name)}")
    return bad
