"""Parallelism layer: mesh composition, logical sharding rules, train step.

The counterpart of ``torchft_tpu/parallel``: in-group parallelism
("data", "fsdp", "tensor") is a static ``DeviceMesh`` over the group's
local ranks, with parameters as ``DTensor``s placed by the logical-axis
rules; the fault-tolerant replica dimension is dynamic and lives with the
Manager, each local rank averaging its own shards across groups.
"""

from torchft_tpu_torch.parallel.mesh import FTMesh, ft_init_mesh
from torchft_tpu_torch.parallel.sharding import ShardingRules, logical_sharding
from torchft_tpu_torch.parallel.trainer import TrainStep

__all__ = [
    "FTMesh",
    "ft_init_mesh",
    "ShardingRules",
    "logical_sharding",
    "TrainStep",
]
