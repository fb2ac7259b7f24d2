"""ray_tpu_torch.parallel: the mesh, sharding strategies, sharded tensors and
the pipeline schedule (counterpart of ``ray_tpu.parallel``).

A single-controller design, as the reference's: one process computes every
slot of a ``Mesh`` of device slots (``devices()``; the environment variable
``RAY_TPU_TORCH_DEVICE_SLOTS=n`` gives n slots of one device), collectives
are differentiable torch ops between the slots, and there is no
``torch.distributed`` process group.
"""
from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    SLOTS_ENV,
    Mesh,
    MeshSpec,
    create_mesh,
    devices,
    local_mesh,
    mesh_shape_for,
)
from ray_tpu_torch.parallel.pipeline import pipeline_apply
from ray_tpu_torch.parallel.sharding import (
    LOGICAL_AXES,
    NamedSharding,
    PartitionSpec,
    ShardedTensor,
    ShardingStrategy,
    device_put,
    logical_sharding,
    shard_pytree,
    use_strategy,
    with_logical_constraint,
)

__all__ = [
    "AXIS_ORDER",
    "LOGICAL_AXES",
    "Mesh",
    "MeshSpec",
    "NamedSharding",
    "PartitionSpec",
    "SLOTS_ENV",
    "ShardedTensor",
    "ShardingStrategy",
    "create_mesh",
    "device_put",
    "devices",
    "local_mesh",
    "logical_sharding",
    "mesh_shape_for",
    "pipeline_apply",
    "shard_pytree",
    "use_strategy",
    "with_logical_constraint",
]
