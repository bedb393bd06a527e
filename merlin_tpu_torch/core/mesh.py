"""Device mesh construction (counterpart of ``merlin_tpu/core/mesh.py``).

One ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
process group, with the JAX package's four axes as its dim names:

  * ``data``    - pure data parallelism (batch rows split, parameters
                  replicated: the replicate dim of FSDP2's HSDP)
  * ``fsdp``    - batch rows split AND parameters sharded along the rules'
                  dim (FSDP2 ``fully_shard``, gathered on use)
  * ``seq``     - ring attention over the sequence (context parallelism)
  * ``tensor``  - heads / MLP columns / vocab split, an all-reduce after
                  each row-parallel product

The ranks are laid out rank-major with ``data`` outermost and ``tensor``
innermost, so a tensor group is the closest ranks (one node's NVLink) and
the data axis spans nodes. ``dcn_data_parallelism`` (JAX's hybrid ICI/DCN
mesh) therefore needs no separate layout here: it is checked to divide the
data axis.

A mesh needs an initialized process group
(:func:`merlin_tpu_torch.utils.dist.init_distributed`, or
``init_process_group`` by the caller). The global mesh (:func:`set_global_mesh`)
is what the attention dispatcher reads to route through ring attention.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

AXIS_DATA = "data"
AXIS_FSDP = "fsdp"
AXIS_TENSOR = "tensor"
AXIS_SEQ = "seq"
AXIS_EXPERT = "expert"

MESH_AXES = (AXIS_DATA, AXIS_FSDP, AXIS_SEQ, AXIS_TENSOR)


@dataclasses.dataclass
class MeshConfig:
    """Parallelism degrees. -1 means "absorb all remaining devices"."""

    data: int = -1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1
    # Split the data axis across nodes.
    dcn_data_parallelism: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        dims = {"data": self.data, "fsdp": self.fsdp, "seq": self.seq,
                "tensor": self.tensor}
        wildcard = [k for k, v in dims.items() if v == -1]
        if len(wildcard) > 1:
            raise ValueError(f"only one mesh axis may be -1, got {wildcard}")
        fixed = math.prod(v for v in dims.values() if v != -1)
        if wildcard:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}")
            dims[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {dims} needs {fixed} devices but {n_devices} available")
        return MeshConfig(dcn_data_parallelism=self.dcn_data_parallelism, **dims)

    @property
    def shape(self):
        return (self.data, self.fsdp, self.seq, self.tensor)


def _require_group() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs an initialized process group: call "
            "merlin_tpu_torch.utils.dist.init_distributed() under torchrun, "
            "or torch.distributed.init_process_group")


def create_mesh(config: Optional[MeshConfig] = None,
                devices: Optional[Sequence[int]] = None, *,
                device_type: Optional[str] = None) -> DeviceMesh:
    """Build the global device mesh over ``devices`` (global ranks, all of
    the process group's by default), data outermost, tensor innermost, on
    ``device_type`` ('cuda' under NCCL, 'cpu' under gloo by default).
    Every rank of the group must call it (DeviceMesh makes the groups)."""
    _require_group()
    ranks = list(devices) if devices is not None \
        else list(range(dist.get_world_size()))
    config = (config or MeshConfig()).resolve(len(ranks))
    if config.dcn_data_parallelism > 1 \
            and config.data % config.dcn_data_parallelism:
        raise ValueError(
            f"dcn_data_parallelism={config.dcn_data_parallelism} must divide "
            f"the data axis ({config.data})")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = np.asarray(ranks, dtype=np.int64).reshape(config.shape)
    return DeviceMesh(device_type, torch.from_numpy(mesh),
                      mesh_dim_names=MESH_AXES)


def single_device_mesh(*, device_type: Optional[str] = None) -> DeviceMesh:
    """1x1x1x1 mesh over this rank (single-card eval/serve path); the
    process group must hold this rank alone."""
    _require_group()
    if dist.get_world_size() != 1:
        raise ValueError("single_device_mesh needs a process group of one "
                         f"rank, not {dist.get_world_size()}")
    return create_mesh(MeshConfig(1, 1, 1, 1), device_type=device_type)


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """The size of mesh axis ``name`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(MESH_AXES.index(name))


def axis_rank(mesh: Optional[DeviceMesh], name: str) -> int:
    """This rank's coordinate on mesh axis ``name`` (0 without a mesh)."""
    if mesh is None:
        return 0
    return mesh.get_coordinate()[MESH_AXES.index(name)]


def dp_size(mesh: Optional[DeviceMesh]) -> int:
    """data x fsdp: the number of batch-row shards."""
    return axis_size(mesh, AXIS_DATA) * axis_size(mesh, AXIS_FSDP)


def dp_rank(mesh: Optional[DeviceMesh]) -> int:
    """This rank's (data, fsdp) coordinate, data-major: its row shard."""
    return (axis_rank(mesh, AXIS_DATA) * axis_size(mesh, AXIS_FSDP)
            + axis_rank(mesh, AXIS_FSDP))


def all_reduce_dp(t: torch.Tensor, mesh: Optional[DeviceMesh],
                  op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce ``t`` in place over the (data, fsdp) ranks of this
    rank's (seq, tensor) coordinate: over data, then over fsdp."""
    for name in (AXIS_DATA, AXIS_FSDP):
        if axis_size(mesh, name) > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(name))
    return t


# --- global mesh context -----------------------------------------------------
# The attention dispatcher reads it to route self-attention through ring
# attention when the seq axis is split. The trainer and the serving engine
# set it.

_GLOBAL_MESH: Optional[DeviceMesh] = None


def set_global_mesh(mesh: Optional[DeviceMesh]) -> None:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh


def get_global_mesh() -> Optional[DeviceMesh]:
    return _GLOBAL_MESH
