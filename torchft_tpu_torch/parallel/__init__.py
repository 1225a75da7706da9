"""Parallelism layer: mesh composition, logical sharding rules, train step.

The counterpart of ``torchft_tpu/parallel``: in-group parallelism
("data", "fsdp", "tensor", "expert"; "pipeline" through
``parallel/pipeline.py``'s schedules) is a static ``DeviceMesh`` over the group's
local ranks, with parameters as ``DTensor``s placed by the logical-axis
rules; the fault-tolerant replica dimension is dynamic and lives with the
Manager, each local rank averaging its own shards across groups.
"""

from torchft_tpu_torch.parallel.mesh import FTMesh, ft_init_mesh
from torchft_tpu_torch.parallel.pipeline import (
    pipeline_1f1b_value_and_grad,
    pipeline_apply,
    pipeline_apply_sharded,
    pipeline_loss_fn,
    pipeline_stage,
)
from torchft_tpu_torch.parallel.sharding import ShardingRules, logical_sharding
from torchft_tpu_torch.parallel.trainer import TrainStep

__all__ = [
    "FTMesh",
    "ft_init_mesh",
    "ShardingRules",
    "logical_sharding",
    "TrainStep",
    "pipeline_1f1b_value_and_grad",
    "pipeline_apply",
    "pipeline_apply_sharded",
    "pipeline_loss_fn",
    "pipeline_stage",
]
