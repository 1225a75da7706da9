"""FTMesh: the static in-group device mesh and the dynamic replica dimension.

The counterpart of ``torchft_tpu/parallel/mesh.py``.  In the JAX package
one process drives a group's whole mesh; here a group is one process a
device (``WORLD_SIZE`` local ranks, each with its own Manager), so:

  - the *in-group* axes (``INTRA_GROUP_AXES``) form a
    ``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks
    (``torch.distributed`` initialized over the group, for example by
    :func:`torchft_tpu_torch.multihost.initialize_slice`); parameters
    become ``DTensor``s whose placements come from the logical-axis rules
    (:meth:`FTMesh.shard_params`);
  - the *replica* axis is no mesh dim: its size is the quorum's
    (``manager.num_participants()``), and across groups each local rank
    averages its own local shards through its own ring (the Manager keys
    its ring by local rank).

How the model computes over the mesh (``models/transformer.py``
``parallelize``): "data" and "fsdp" split the group's batch, each rank
taking its own slice (:meth:`FTMesh.batch_shard`); a parameter sharded
over either is all-gathered for its use and its gradient reduce-scattered
and averaged (:func:`~.functional.gather_shards`), and one replicated over
either has its gradient averaged.  "sequence" splits each sequence of the
rank's batch (``data.shard_sequence``): attention crosses the shards by
ring attention or Ulysses (``ops/``), each rank's loss is the mean over
its own tokens, and every parameter, replicated over it, has its gradient
averaged over it.  "tensor" keeps each rank's slice of the
heads, the MLP and the vocabulary (Megatron-style, with the sums placed by
:mod:`.functional`).  "expert" keeps each rank's slice of the stacked
experts (``models/moe.py``): the batch is replicated over it and the
combine's partial outputs are summed over it.  "pipeline" holds no
parameter dim: each stage keeps its own layer modules
(``parallel/pipeline.py`` ``pipeline_stage``) and its other parameters are
replicated over it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from torchft_tpu_torch.parallel import functional as F
from torchft_tpu_torch.parallel.sharding import ShardingRules

__all__ = ["FTMesh", "INTRA_GROUP_AXES", "REPLICA_AXIS", "ft_init_mesh"]

# Axis names understood by the default sharding rules.
INTRA_GROUP_AXES = ("data", "fsdp", "tensor", "sequence", "expert", "pipeline")
REPLICA_AXIS = "replica"
BATCH_AXES = ("data", "fsdp")
# The axes over which each rank computes on its own slice of the group's
# tokens: a parameter's gradient is averaged (or reduce-scattered) over them.
TOKEN_AXES = BATCH_AXES + ("sequence",)


@dataclasses.dataclass
class FTMesh:
    """A static in-group mesh plus the managed (dynamic) replica dimension.

    ``mesh`` is None for a one-rank group outside ``torch.distributed``:
    every parameter then stays a plain tensor."""

    mesh: Optional[Any] = None  # torch.distributed.device_mesh.DeviceMesh
    manager: Optional[Any] = None  # torchft_tpu_torch.manager.Manager
    rules: ShardingRules = dataclasses.field(default_factory=ShardingRules)

    # -- axis queries (the JAX FTMesh's) --------------------------------------

    @property
    def mesh_axis_names(self) -> Tuple[str, ...]:
        """The in-group axes, in mesh-dim order."""
        return tuple(self.mesh.mesh_dim_names) if self.mesh is not None else ()

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (REPLICA_AXIS,) + self.mesh_axis_names

    def size(self, axis: Optional[str] = None) -> int:
        """Total size; the replica axis reports the current quorum's size."""
        if axis is None:
            return math.prod(self.size(a) for a in self.axis_names)
        if axis == REPLICA_AXIS:
            if self.manager is None:
                return 1
            return max(1, self.manager.num_participants())
        if axis not in self.mesh_axis_names:
            return 1
        return int(self.mesh.size(self.mesh_axis_names.index(axis)))

    def replica_rank(self) -> Optional[int]:
        if self.manager is None:
            return 0
        return self.manager.participating_rank()

    def coordinate(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on an axis the mesh lacks)."""
        if axis not in self.mesh_axis_names:
            return 0
        return int(self.mesh.get_local_rank(axis))

    def group(self, axis: str):
        """The process group of ``axis``: this rank's peers along it."""
        return self.mesh.get_group(axis)

    def batch_shard(self) -> Tuple[int, int]:
        """(rank, count) of this rank's slice of the group's batch: the
        batch axes ("data" major, then "fsdp") split it; "tensor" ranks
        share theirs, and "sequence" ranks too, each taking its own slice of
        every sequence (``data.shard_sequence``)."""
        rank, count = 0, 1
        for axis in BATCH_AXES:
            rank = rank * self.size(axis) + self.coordinate(axis)
            count *= self.size(axis)
        return rank, count

    # -- sharding ----------------------------------------------------------------

    def spec(self, *logical_axes: Optional[str]) -> Tuple[Optional[str], ...]:
        return self.rules.spec(logical_axes, self)

    def placements(self, *logical_axes: Optional[str]) -> tuple:
        return self.rules.placements(logical_axes, self)

    def local_shard(self, full: torch.Tensor, placements: Sequence[Any]) -> torch.Tensor:
        """This rank's slice of ``full`` under ``placements`` (a view).  A
        sharded dim must divide evenly: the JAX package's NamedSharding
        requires the same."""
        out = full
        for i, (name, pl) in enumerate(zip(self.mesh_axis_names, placements)):
            if not pl.is_shard():
                continue
            n = int(self.mesh.size(i))
            if out.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of shape {tuple(full.shape)} does not divide "
                                 f"over the {n} ranks of mesh axis {name!r}")
            out = out.chunk(n, dim=pl.dim)[self.coordinate(name)]
        return out

    def distribute(self, full: torch.Tensor, logical_axes: Sequence[Optional[str]]) -> torch.Tensor:
        """``full`` (the same on every rank) as a DTensor of this rank's
        shard, with no communication; ``full`` itself without a mesh."""
        if self.mesh is None:
            return full
        from torch.distributed.tensor import DTensor

        placements = self.rules.placements(logical_axes, self)
        local = self.local_shard(full.detach(), placements).clone()
        return DTensor.from_local(local, self.mesh, placements, run_check=False,
                                  shape=full.shape, stride=full.stride())

    def shard_params(self, module: nn.Module, axes: Mapping[str, Tuple[Optional[str], ...]]
                     ) -> nn.Module:
        """Places ``module``'s parameters on the mesh per their logical axes
        (``axes``: parameter name -> logical-axis tuple, as ``param_axes``
        gives), in place; every rank must hold the same full values (one
        seed).  A parameter ``axes`` does not name raises ``KeyError``."""
        if self.mesh is None:
            return module
        for name, p in list(module.named_parameters()):
            owner_name, _, attr = name.rpartition(".")
            owner = module.get_submodule(owner_name) if owner_name else module
            owner.register_parameter(attr, nn.Parameter(self.distribute(p.data, axes[name]),
                                                        requires_grad=p.requires_grad))
        return module

    # -- compute ----------------------------------------------------------------

    def materialize(self, p: torch.Tensor) -> torch.Tensor:
        """The plain tensor a rank computes with from parameter ``p``: a
        DTensor's local shard, all-gathered over the batch axes it is
        sharded on (its gradient reduce-scattered and averaged there), its
        gradient averaged over the batch axes and "sequence" it is
        replicated on, and kept as this rank's slice over "tensor" and
        "expert".  Over "pipeline" it is replicated (a stage's layers are
        its own modules).  A plain tensor is returned as it is."""
        from torch.distributed.tensor import DTensor

        if not isinstance(p, DTensor):
            return p
        x = p.to_local()
        for i, (name, pl) in enumerate(zip(self.mesh_axis_names, p.placements)):
            if name not in TOKEN_AXES or int(self.mesh.size(i)) == 1:
                continue
            group = self.group(name)
            x = F.gather_shards(x, pl.dim, group) if pl.is_shard() else F.average_grad(x, group)
        return x

    def full_tensor(self, t: torch.Tensor) -> torch.Tensor:
        """The global value of ``t``, a DTensor on this mesh: its local
        shards all-gathered over every mesh dim that shards it, by plain
        ``torch.distributed`` calls (DTensor's own ``full_tensor`` runs
        functional collectives, which crash on gloo over CUDA tensors:
        PERF.md).  No gradient; a plain tensor comes back as it is."""
        from torch.distributed.tensor import DTensor

        if not isinstance(t, DTensor):
            return t
        with torch.no_grad():
            x = t.to_local()
            for i, (name, pl) in enumerate(zip(self.mesh_axis_names, t.placements)):
                if pl.is_shard() and int(self.mesh.size(i)) > 1:
                    x = F.all_gather_cat(x, pl.dim, self.group(name))
        return x


def ft_init_mesh(
    axis_sizes: Dict[str, int],
    manager: Optional[Any] = None,
    device_type: str = "cuda",
    rules: Optional[ShardingRules] = None,
) -> FTMesh:
    """Builds an FTMesh from {axis: size} over the ranks of the initialized
    ``torch.distributed`` world (rank-major in the order given).

    The "replica" axis, if present, is ignored for placement: it is the
    cross-group dimension the Manager handles.  An unknown axis raises
    ``ValueError``.  A one-rank mesh outside ``torch.distributed`` has no
    DeviceMesh (``FTMesh.mesh`` None)."""
    import torch.distributed as dist

    sizes = {k: int(v) for k, v in axis_sizes.items() if k != REPLICA_AXIS}
    for name in sizes:
        if name not in INTRA_GROUP_AXES:
            raise ValueError(f"unknown mesh axis {name!r}; use {INTRA_GROUP_AXES}")
    n = math.prod(sizes.values()) if sizes else 1
    rules = rules or ShardingRules()
    if not (dist.is_available() and dist.is_initialized()):
        if n > 1:
            raise ValueError(f"mesh needs {n} ranks; torch.distributed is not initialized")
        return FTMesh(mesh=None, manager=manager, rules=rules)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh needs {n} ranks, have {world}")
    from torch.distributed.device_mesh import init_device_mesh

    names = tuple(sizes) or ("data",)
    shape = tuple(sizes.values()) or (1,)
    mesh = init_device_mesh(device_type, shape, mesh_dim_names=names)
    return FTMesh(mesh=mesh, manager=manager, rules=rules)
