"""Logical-axis sharding rules.

The counterpart of ``torchft_tpu/parallel/sharding.py``.  Model code names
tensor axes logically ("batch", "seq", "embed", "heads", "mlp", "vocab",
"expert", "layers"); a :class:`ShardingRules` table maps logical names to
the in-group mesh's axes ("data", "fsdp", "tensor", "sequence", "expert",
"pipeline").  The JAX package hands the result to XLA as a
``PartitionSpec``; here it becomes a ``DTensor``'s placements, one per mesh
dim: ``Shard(d)`` where tensor dim ``d`` maps to that mesh axis, else
``Replicate()``.

:meth:`ShardingRules.spec` returns the tuple a JAX ``PartitionSpec`` holds,
so the two packages' layouts can be compared entry for entry.

``mesh`` is anything that names its axes: an :class:`~.mesh.FTMesh`, a
``DeviceMesh`` (its ``mesh_dim_names``) or a sequence of axis names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch

__all__ = ["ShardingRules", "axis_names", "constrain", "logical_sharding"]


def axis_names(mesh: Any) -> Tuple[str, ...]:
    """The in-group axis names of ``mesh`` (see the module docstring)."""
    if mesh is None:
        return ()
    if isinstance(mesh, (tuple, list)):
        return tuple(mesh)
    names = getattr(mesh, "mesh_axis_names", None)  # FTMesh: without "replica"
    if names is None:
        names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"cannot read axis names from {type(mesh).__name__}")
    return tuple(names)


def _is_axes(x: Any) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis -> mesh axis (or None = replicated)."""

    rules: Tuple[Tuple[str, Optional[str]], ...] = (
        ("batch", "data"),
        ("seq", "sequence"),
        ("embed", "fsdp"),
        ("heads", "tensor"),
        ("kv_heads", "tensor"),
        ("mlp", "tensor"),
        ("vocab", "tensor"),
        ("expert", "expert"),
        # Stacked-layer leading axis of the JAX package; the port keeps one
        # module a layer, so no port tensor carries it.
        ("layers", "pipeline"),
    )

    def mesh_axis(self, logical: Optional[str], mesh: Any) -> Optional[str]:
        if logical is None:
            return None
        names = axis_names(mesh)
        for name, axis in self.rules:
            if name == logical:
                # An axis the mesh lacks leaves the dimension replicated.
                return axis if axis in names else None
        return None

    def spec(self, logical_axes: Sequence[Optional[str]], mesh: Any) -> Tuple[Optional[str], ...]:
        """The mesh axis of each tensor dim: the entries of the JAX
        ``PartitionSpec`` for the same logical axes."""
        seen = set()
        out = []
        for ax in logical_axes:
            m = self.mesh_axis(ax, mesh)
            # A mesh axis may shard at most one tensor dim.
            if m is not None and m in seen:
                m = None
            if m is not None:
                seen.add(m)
            out.append(m)
        return tuple(out)

    def placements(self, logical_axes: Sequence[Optional[str]], mesh: Any) -> tuple:
        """One ``DTensor`` placement per mesh dim, in the mesh's axis order."""
        from torch.distributed.tensor import Replicate, Shard

        spec = self.spec(logical_axes, mesh)
        return tuple(Shard(spec.index(name)) if name in spec else Replicate()
                     for name in axis_names(mesh))


def logical_sharding(tree_axes: Any, mesh: Any, rules: Optional[ShardingRules] = None) -> Any:
    """Maps a tree (dicts, lists) of logical-axis tuples to the same tree of
    placement tuples (:meth:`ShardingRules.placements`)."""
    rules = rules or ShardingRules()

    def walk(node: Any) -> Any:
        if _is_axes(node):
            return rules.placements(node, mesh)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        raise TypeError(f"not a logical-axis tuple: {node!r}")

    return walk(tree_axes)


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]], mesh: Any,
              rules: Optional[ShardingRules] = None) -> torch.Tensor:
    """The JAX package's ``with_sharding_constraint`` by logical axes: a
    ``DTensor`` is redistributed to the placements the rules give on its own
    mesh; a plain tensor, and any tensor without a mesh, is returned as it
    is (the port's model computes on local tensors and places its
    collectives itself, ``models/transformer.py``)."""
    from torch.distributed.tensor import DTensor

    if mesh is None or not isinstance(x, DTensor):
        return x
    rules = rules or ShardingRules()
    return x.redistribute(x.device_mesh, rules.placements(axes, x.device_mesh))
