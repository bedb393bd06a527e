from merlin_tpu_torch.core.mesh import (
    AXIS_DATA, AXIS_FSDP, AXIS_TENSOR, MeshConfig, create_mesh)
from merlin_tpu_torch.core.partitioning import (
    DEFAULT_LOGICAL_AXIS_RULES,
    logical_axis_rules,
    sharding_for_tree,
)
from merlin_tpu_torch.core.precision import DEFAULT_POLICY, Policy
