"""The port's in-group mesh layer against the JAX package's: the logical-axis
rules (each spec equal to the JAX PartitionSpec), FTMesh's axis queries
with a dynamic replica axis, the axes it refuses, placements and local
shards, and ``shard_batch``.

Meshes over several ranks run in this process on torch's "fake" process
group (no peers, no collectives): enough for DeviceMesh coordinates and
DTensors built from local shards."""

from __future__ import annotations

from unittest.mock import create_autospec

import numpy as np
import pytest
import torch
import torch.distributed as dist

from torch_port_ref import import_reference
from torchft_tpu_torch.data import shard_batch, shard_sequence
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.models import Transformer, TransformerConfig, param_axes
from torchft_tpu_torch.parallel import FTMesh, ShardingRules, ft_init_mesh, logical_sharding
from torchft_tpu_torch.parallel.sharding import constrain

SMALL = dict(vocab_size=512, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=256,
             max_seq=64)
MESHES = {"data2": {"data": 2}, "fsdp2_tensor2": {"fsdp": 2, "tensor": 2},
          "data2_tensor2_sequence2": {"data": 2, "tensor": 2, "sequence": 2}}


@pytest.fixture(scope="module")
def ref():
    return import_reference("torchft_tpu.models.transformer"), \
        import_reference("torchft_tpu.parallel")


def _jax_mesh(sizes):
    import jax
    from jax.sharding import Mesh

    n = int(np.prod(list(sizes.values())))
    return Mesh(np.array(jax.devices()[:n]).reshape(tuple(sizes.values())), tuple(sizes))


def _jax_tuples(ref_model):
    import jax.numpy as jnp

    cfg = ref_model.TransformerConfig(**SMALL, dtype=jnp.float32)
    axes = ref_model.param_axes(cfg)
    out = [axes["embed"], axes["final_norm"], axes["lm_head"]]
    return out + list(axes["layers"].values())


@pytest.fixture
def fake_world():
    """A fake process group of ``n`` ranks with this process at ``rank``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def init(n: int, rank: int = 0) -> None:
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=n)

    yield init
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_spec_equals_jax_partition_spec(ref, mesh_name) -> None:
    ref_model, ref_parallel = ref
    sizes = MESHES[mesh_name]
    jmesh, jrules, rules = _jax_mesh(sizes), ref_parallel.ShardingRules(), ShardingRules()
    names = tuple(sizes)
    port = list(param_axes(TransformerConfig(**SMALL)).values())
    for axes in port + _jax_tuples(ref_model) + [("batch", "seq")]:
        assert rules.spec(axes, names) == tuple(jrules.spec(axes, jmesh)), axes


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_port_axes_are_the_jax_axes_transposed(ref, mesh_name) -> None:
    """Each port weight's spec is the JAX weight's, [in, out] -> [out, in],
    without the stacked "layers" axis."""
    ref_model, ref_parallel = ref
    import jax.numpy as jnp

    sizes = MESHES[mesh_name]
    jmesh, jrules = _jax_mesh(sizes), ref_parallel.ShardingRules()
    jaxes = ref_model.param_axes(ref_model.TransformerConfig(**SMALL, dtype=jnp.float32))
    port = param_axes(TransformerConfig(**SMALL))
    names = tuple(sizes)
    for name, axes in jaxes["layers"].items():
        want = tuple(jrules.spec(axes, jmesh))[1:]  # drop "layers"
        got = ShardingRules().spec(port[f"layers.0.{name}" + (".weight" if name.startswith("w")
                                                             else "")], names)
        assert got == (want[::-1] if len(want) == 2 else want), name
    for name in ("embed", "final_norm", "lm_head"):
        key = "embed.weight" if name == "embed" else name
        assert ShardingRules().spec(port[key], names) == tuple(jrules.spec(jaxes[name], jmesh))


def test_param_axes_names_every_parameter() -> None:
    model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32), device="cpu")
    axes = param_axes(model.cfg)
    assert set(axes) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert len(axes[name]) == p.dim(), name


def test_a_mesh_axis_shards_one_dim_at_most() -> None:
    rules = ShardingRules()
    assert rules.spec(("heads", "mlp"), ("tensor",)) == ("tensor", None)
    assert rules.spec(("embed", "embed"), ("fsdp", "tensor")) == ("fsdp", None)
    assert rules.spec(("embed", None), ()) == (None, None)


def test_ftmesh_dynamic_replica_size(fake_world) -> None:
    fake_world(4, rank=3)
    manager = create_autospec(Manager, instance=True)
    manager.num_participants.return_value = 3
    manager.participating_rank.return_value = 1
    ftmesh = ft_init_mesh({"data": 2, "tensor": 2}, manager=manager, device_type="cpu")
    assert ftmesh.size("replica") == 3
    assert ftmesh.size("data") == 2
    assert ftmesh.size() == 12  # 3 replicas x 4 local ranks
    assert ftmesh.replica_rank() == 1
    assert ftmesh.axis_names == ("replica", "data", "tensor")
    assert (ftmesh.coordinate("data"), ftmesh.coordinate("tensor")) == (1, 1)
    assert ftmesh.batch_shard() == (1, 2)
    assert ftmesh.size("fsdp") == 1 and ftmesh.coordinate("fsdp") == 0


def test_ftmesh_replica_axis_is_dropped_for_placement(fake_world) -> None:
    fake_world(2)
    ftmesh = ft_init_mesh({"replica": 5, "fsdp": 2}, device_type="cpu")
    assert ftmesh.mesh_axis_names == ("fsdp",)
    assert ftmesh.size("replica") == 1 and ftmesh.replica_rank() == 0


def test_ftmesh_rejects_unknown_axis() -> None:
    with pytest.raises(ValueError, match="unknown mesh axis"):
        ft_init_mesh({"bogus": 2})


@pytest.mark.parametrize("axis", ["sequence", "expert", "pipeline"])
def test_q14_axes_above_one_raise(fake_world, axis) -> None:
    """The Q1.4 axes are ported and none raises any more: a mesh over
    "expert" places the experts' dim on it; "pipeline" keeps every
    parameter whole; "sequence" keeps every parameter whole, splits the
    "seq" dim and not the batch, and averages each parameter's gradient over
    it (on the fake group the all-reduce leaves the gradient as it is, so
    the averages over "data" and "sequence" halve it twice)."""
    from torch.distributed.tensor import Replicate, Shard

    if axis == "sequence":
        fake_world(4, rank=3)
        ftmesh = ft_init_mesh({"data": 2, axis: 2}, device_type="cpu")
        assert ftmesh.coordinate(axis) == 1 and ftmesh.batch_shard() == (1, 2)
        assert ftmesh.spec("batch", "seq") == ("data", "sequence")
        cfg = TransformerConfig(**SMALL, dtype=torch.float32, attention="ring")
        model = Transformer(cfg, device="cpu")
        ftmesh.shard_params(model, param_axes(cfg))
        for name, p in model.named_parameters():
            assert p.placements == (Replicate(), Replicate()), name
        w = model.layers[0].attn_norm
        ftmesh.materialize(w).sum().backward()
        assert torch.equal(w.grad.to_local(), torch.full_like(w.grad.to_local(), 0.25))
        return

    fake_world(4, rank=3)  # data coordinate 1, axis coordinate 1
    ftmesh = ft_init_mesh({"data": 2, axis: 2}, device_type="cpu")
    assert ftmesh.mesh_axis_names == ("data", axis) and ftmesh.size(axis) == 2
    assert ftmesh.coordinate(axis) == 1 and ftmesh.batch_shard() == (1, 2)
    cfg = TransformerConfig(**SMALL, dtype=torch.float32, moe_experts=4)
    axes = param_axes(cfg)
    want = Shard(0) if axis == "expert" else Replicate()
    assert ftmesh.placements(*axes["layers.0.w_gate"]) == (Replicate(), want)
    assert ftmesh.placements(*axes["layers.0.router"]) == (
        Replicate(), Shard(1) if axis == "expert" else Replicate())
    full = torch.arange(4 * 8 * 2, dtype=torch.float32).reshape(4, 8, 2)
    local = ftmesh.local_shard(full, ftmesh.placements("expert", "embed", "mlp"))
    assert torch.equal(local, full[2:] if axis == "expert" else full)


def test_q14_axis_of_size_one_is_kept(fake_world) -> None:
    fake_world(2)
    ftmesh = ft_init_mesh({"fsdp": 2, "sequence": 1}, device_type="cpu")
    assert ftmesh.mesh_axis_names == ("fsdp", "sequence")
    assert ftmesh.spec("batch", "seq") == (None, "sequence")


def test_mesh_needs_the_world_it_names(fake_world) -> None:
    with pytest.raises(ValueError, match="not initialized"):
        ft_init_mesh({"fsdp": 2}, device_type="cpu")
    alone = ft_init_mesh({"fsdp": 1}, device_type="cpu")
    assert alone.mesh is None and alone.size() == 1
    fake_world(4)
    with pytest.raises(ValueError, match="needs 2 ranks, have 4"):
        ft_init_mesh({"fsdp": 2}, device_type="cpu")


def test_placements_and_local_shards(fake_world) -> None:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    fake_world(4, rank=2)  # fsdp coordinate 1, tensor coordinate 0
    ftmesh = ft_init_mesh({"fsdp": 2, "tensor": 2}, device_type="cpu")
    assert ftmesh.placements("heads", "embed") == (Shard(1), Shard(0))
    assert ftmesh.placements("embed") == (Shard(0), Replicate())
    assert ftmesh.placements(None, None) == (Replicate(), Replicate())
    full = torch.arange(32.0).reshape(4, 8)
    t = ftmesh.distribute(full, ("heads", "embed"))
    assert isinstance(t, DTensor) and t.shape == full.shape
    assert torch.equal(t.to_local(), full[:2, 4:])
    with pytest.raises(ValueError, match="does not divide"):
        ftmesh.distribute(torch.zeros(3, 8), ("heads", "embed"))


def test_shard_params_places_every_parameter(fake_world) -> None:
    from torch.distributed.tensor import DTensor

    fake_world(4, rank=1)
    ftmesh = ft_init_mesh({"fsdp": 2, "tensor": 2}, device_type="cpu")
    model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32), device="cpu")
    full = {n: p.detach().clone() for n, p in model.named_parameters()}
    ftmesh.shard_params(model, param_axes(model.cfg))
    axes = param_axes(model.cfg)
    for name, p in model.named_parameters():
        assert isinstance(p, DTensor) and isinstance(p, torch.nn.Parameter), name
        assert p.placements == ftmesh.placements(*axes[name])
        assert torch.equal(p.to_local(), ftmesh.local_shard(full[name], p.placements)), name


def test_logical_sharding_tree_and_constrain(fake_world) -> None:
    from torch.distributed.tensor import Replicate, Shard

    fake_world(2)
    ftmesh = ft_init_mesh({"tensor": 2}, device_type="cpu")
    tree = logical_sharding({"a": ("embed", "vocab"), "b": [("heads",)]}, ftmesh)
    assert tree == {"a": (Shard(1),), "b": [(Shard(0),)]}
    assert logical_sharding({"c": (None,)}, ftmesh) == {"c": (Replicate(),)}
    x = torch.ones(4, 4)
    assert constrain(x, ("batch", "embed"), ftmesh) is x
    assert constrain(x, ("batch", "embed"), None) is x


def test_ftmesh_without_mesh_keeps_plain_tensors() -> None:
    ftmesh = FTMesh()
    model = Transformer(TransformerConfig(**SMALL, dtype=torch.float32), device="cpu")
    ftmesh.shard_params(model, param_axes(model.cfg))
    assert all(type(p) is torch.nn.Parameter for p in model.parameters())
    assert ftmesh.size() == 1 and ftmesh.batch_shard() == (0, 1)


GRID = [(g, ng, r, nr) for ng in (1, 2, 3) for g in range(ng) for nr in (1, 2, 4)
        for r in range(nr)]


@pytest.mark.parametrize("n", [8, 13, 24])
def test_shard_batch_equals_jax(n) -> None:
    ref_data = import_reference("torchft_tpu.data")
    idx = list(np.random.default_rng(n).permutation(100)[:n])
    for g, ng, r, nr in GRID:
        np.testing.assert_array_equal(shard_batch(idx, g, ng, r, nr),
                                      ref_data.shard_batch(idx, g, ng, r, nr))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_sequence_equals_jax_placement(ref, n) -> None:
    """Each "sequence" rank's slice is the block the JAX package's
    ``ftmesh.sharding("batch", "seq")`` places on the device at that
    coordinate, for numpy and torch batches."""
    import jax

    ref_parallel = ref[1]
    ftmesh = ref_parallel.ft_init_mesh({"sequence": n})
    x = np.random.default_rng(n).integers(0, 512, size=(3, 64)).astype(np.int32)
    placed = jax.device_put(x, ftmesh.sharding("batch", "seq"))
    devices = list(ftmesh.mesh.devices.reshape(-1))
    for shard in placed.addressable_shards:
        s = devices.index(shard.device)
        np.testing.assert_array_equal(shard_sequence(x, s, n), np.asarray(shard.data))
        assert torch.equal(shard_sequence(torch.from_numpy(x), s, n),
                           torch.from_numpy(np.asarray(shard.data)))
    with pytest.raises(ValueError, match="does not divide"):
        shard_sequence(x[:, :63], 0, n)
