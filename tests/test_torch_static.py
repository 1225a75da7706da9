"""The port stands alone: it imports nothing of JAX or of the JAX package,
nor ``ml_dtypes`` (absent on the card's machine; the bf16 wire casts
through torch), imports without CUDA, and its card entry points raise
instead of silently running on the CPU."""

from __future__ import annotations

import ast
import importlib
import os
import pkgutil

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "torchft_tpu", "ml_dtypes"}


def _port_files():
    pkg = os.path.join(REPO, "torchft_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_roots(path: str):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    yield arg.value.split(".")[0]


def test_port_imports_nothing_of_jax_or_the_jax_package() -> None:
    files = list(_port_files())
    assert len(files) > 10
    scanned = {os.path.relpath(p, REPO) for p in files}
    for healing in ("ec/__init__.py", "ec/gf.py", "ec/encoder.py", "ec/placement.py",
                    "ec/store.py", "ha/__init__.py", "ha/backoff.py",
                    "checkpointing/integrity.py", "checkpointing/_rwlock.py",
                    "drain/__init__.py", "drain/watcher.py"):
        assert os.path.join("torchft_tpu_torch", healing) in scanned, healing
    bad = {
        os.path.relpath(p, REPO): sorted(set(_imported_roots(p)) & FORBIDDEN)
        for p in files
    }
    assert {k: v for k, v in bad.items() if v} == {}


def test_the_collective_plane_stands_alone() -> None:
    """The modules of the collective plane (the ring, its native binding,
    the futures) and ``chip_smoke.py`` are scanned, import nothing of JAX,
    the JAX package or ``ml_dtypes``, and the ring unpickles peers' frames
    with its own restricted unpickler only."""
    import pickle

    from torchft_tpu_torch import collectives

    for rel in ("torchft_tpu_torch/collectives.py", "torchft_tpu_torch/_native.py",
                "torchft_tpu_torch/futures.py", "chip_smoke.py"):
        path = os.path.join(REPO, rel)
        assert os.path.join(REPO, rel) in set(_port_files()), rel
        assert not set(_imported_roots(path)) & FORBIDDEN, rel
    import torchft_tpu_torch

    for name in ("LinkShaper", "ErrorSwallowingCollective", "ManagedCollective"):
        assert name in collectives.__all__, name
    for name in ("ErrorSwallowingCollective", "ManagedCollective"):
        assert getattr(torchft_tpu_torch, name) is getattr(collectives, name)
        assert name in torchft_tpu_torch.__all__
    src = open(os.path.join(REPO, "torchft_tpu_torch", "collectives.py")).read()
    assert "pickle.loads" not in src
    with pytest.raises(pickle.UnpicklingError, match="only numpy"):
        collectives._frame_loads(pickle.dumps(os.system))


def test_the_detect_and_act_plane_stands_alone() -> None:
    """The worker endpoint, incident capture, the watcher, the incident CLI
    and the launcher are scanned and import nothing of JAX or the JAX
    package (``obs/incident.py`` and ``obs/watcher.py`` are the port's own
    copies of pure-Python JAX modules); their entry points are exported."""
    scanned = set(_port_files())
    for rel in ("obs/prom.py", "obs/incident.py", "obs/watcher.py", "tools/incident.py",
                "launch.py", "examples/_common.py"):
        path = os.path.join(REPO, "torchft_tpu_torch", rel)
        assert path in scanned, rel
        assert not set(_imported_roots(path)) & FORBIDDEN, rel
        assert "torchft_tpu." not in open(path).read().replace("torchft_tpu_torch", ""), rel
    from torchft_tpu_torch import launch, obs
    from torchft_tpu_torch.obs import watcher

    assert "fetch_alerts" in launch.__all__ and "WorkerMetrics" in obs.__all__
    assert set(watcher.__all__) == {"IncidentWatcher", "POLICY_BY_KIND", "main"}


def test_the_in_group_modules_stand_alone() -> None:
    """The mesh, the rules, the in-group collectives, the slice bootstrap,
    the pipeline, the mixture of experts, ring attention, Ulysses and the
    HSDP, pipeline and ring examples are scanned and import nothing of JAX
    or the JAX package; their entry points are exported."""
    scanned = set(_port_files())
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/sharding.py",
                "parallel/functional.py", "parallel/pipeline.py", "models/moe.py",
                "ops/ring_attention.py", "ops/ulysses.py", "multihost.py",
                "examples/train_hsdp.py", "examples/train_pipeline.py",
                "examples/train_ring.py"):
        path = os.path.join(REPO, "torchft_tpu_torch", rel)
        assert path in scanned, rel
        assert not set(_imported_roots(path)) & FORBIDDEN, rel
        assert "torchft_tpu." not in open(path).read().replace("torchft_tpu_torch", ""), rel
    from torchft_tpu_torch import models, multihost, parallel
    from torchft_tpu_torch.ops import ring_attention, ulysses
    from torchft_tpu_torch.parallel import functional

    assert {"FTMesh", "ft_init_mesh", "ShardingRules", "logical_sharding", "TrainStep",
            "pipeline_1f1b_value_and_grad", "pipeline_apply", "pipeline_apply_sharded",
            "pipeline_loss_fn", "pipeline_stage"} == set(parallel.__all__)
    assert {"SliceConfig", "slice_config_from_env", "initialize_slice"} == set(multihost.__all__)
    assert {"param_axes", "parallelize", "moe_ffn", "moe_capacity"} <= set(models.__all__)
    assert {"ring_attention", "ring_attention_sharded", "zigzag_permutation",
            "inverse_zigzag_permutation", "to_zigzag", "from_zigzag"} == set(ring_attention.__all__)
    assert {"ulysses_attention", "ulysses_attention_sharded", "check_heads"} == set(
        ulysses.__all__)
    assert {"all_to_all", "ring_hop", "mean_value"} <= set(functional.__all__)


def test_the_durable_state_and_isolation_modules_stand_alone() -> None:
    """Disk checkpoints, the collective transport, the stateful loader, the
    baby collective and the parameter server are scanned and import
    nothing of JAX or the JAX package (``data.py``'s loader and
    ``baby.py``'s pipe are the port's own copies of pure-Python JAX
    code); received headers go through the restricted unpickler only; the
    entry points are exported."""
    scanned = set(_port_files())
    for rel in ("checkpointing/disk.py", "checkpointing/collective_transport.py",
                "checkpointing/__init__.py", "data.py", "baby.py", "parameter_server.py",
                "examples/train_ddp.py", "examples/kill_heal.py"):
        path = os.path.join(REPO, "torchft_tpu_torch", rel)
        assert path in scanned, rel
        assert not set(_imported_roots(path)) & FORBIDDEN, rel
        src = open(path).read()
        assert "torchft_tpu." not in src.replace("torchft_tpu_torch", ""), rel
        assert "pickle.loads" not in src, rel
    from torchft_tpu_torch import baby, checkpointing, data, parameter_server

    assert {"CollectiveTransport", "DiskCheckpointer", "ManagedDiskCheckpoint",
            "HTTPTransport", "CheckpointTransport"} == set(checkpointing.__all__)
    assert set(data.__all__) == {"DistributedSampler", "StatefulDataLoader", "shard_batch",
                                 "shard_sequence"}
    assert set(baby.__all__) == {"MonitoredPipe", "BabyCollective", "BabyTCPCollective"}
    assert set(parameter_server.__all__) == {"ParameterServer", "TCPParameterServer"}


def test_the_control_plane_stands_alone() -> None:
    """The lease, the replicated lighthouse, federation and the CLIs are
    scanned and import nothing of JAX or the JAX package (``ha/lease.py``
    is the port's own copy of a JAX module that imports no JAX, and the
    wire types are the port's codec, not ``tpuft_pb2``); the entry points
    are exported."""
    scanned = set(_port_files())
    for rel in ("ha/__init__.py", "ha/lease.py", "ha/replica.py", "federation/__init__.py",
                "federation/region.py", "federation/root.py", "lighthouse_cli.py",
                "store_cli.py", "coordination.py", "_wire.py", "_native.py"):
        path = os.path.join(REPO, "torchft_tpu_torch", rel)
        assert path in scanned, rel
        assert not set(_imported_roots(path)) & (FORBIDDEN | {"google"}), rel
        src = open(path).read()
        assert "torchft_tpu." not in src.replace("torchft_tpu_torch", ""), rel
        assert "import tpuft_pb2" not in src and "tpuft_pb2 as" not in src, rel
    from torchft_tpu_torch import coordination, federation, ha

    assert set(ha.__all__) == {"DecorrelatedBackoff", "FileLease", "LeaseRecord",
                               "HALighthouse"}
    assert set(federation.__all__) == {"RegionLighthouse", "RootLighthouse"}
    assert {"Quorum", "QuorumMember", "LighthouseClient"} <= set(coordination.__all__)


def test_every_port_module_imports_without_cuda() -> None:
    import torchft_tpu_torch

    names = [
        m.name
        for m in pkgutil.walk_packages(torchft_tpu_torch.__path__, "torchft_tpu_torch.")
    ]
    assert "torchft_tpu_torch.ops.attention" in names
    assert "torchft_tpu_torch.drain.watcher" in names
    for name in ("obs.prom", "obs.incident", "obs.watcher", "tools.incident",
                 "checkpointing.disk", "checkpointing.collective_transport", "baby",
                 "parameter_server", "ha.lease", "ha.replica", "federation.region",
                 "federation.root", "lighthouse_cli", "store_cli", "coordination"):
        assert f"torchft_tpu_torch.{name}" in names, name
    for name in names:
        importlib.import_module(name)


def test_card_entry_point_raises_without_a_card(monkeypatch) -> None:
    from torchft_tpu_torch.models import Transformer, TransformerConfig, resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Transformer(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    Transformer(cfg, device="cpu")


def test_kernel_wrappers_reject_what_the_kernels_do_not_take() -> None:
    """The shape and dtype checks run before any launch."""
    from torchft_tpu_torch.ops import attention, cross_entropy

    with pytest.raises(ValueError, match="D in"):
        attention._check_shapes("flash_fwd", torch.zeros(2, 16, 64))
    with pytest.raises(ValueError, match="shape"):
        attention._check_shapes("flash_fwd", torch.zeros(2, 16, 128), torch.zeros(2, 8, 128))
    with pytest.raises(ValueError, match="CUDA"):
        cross_entropy._check("ce_lse", torch.zeros(4, 16, dtype=torch.bfloat16),
                             torch.zeros(16, 8, dtype=torch.bfloat16))


@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float16, torch.float32),
    (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16),
    (torch.float64, torch.float64),
])
def test_rms_norm_wrapper_rejects_unbuilt_dtype_pairs(x_dtype, w_dtype) -> None:
    """Only (bf16, f32) and (f32, f32) are instantiated: any other pair
    raises before a launch, whatever the device; the two built pairs pass
    the dtype check and then need a card."""
    from torchft_tpu_torch.ops import rmsnorm

    before = rmsnorm.RMS_NORM.launches
    with pytest.raises(TypeError, match="no kernel"):
        rmsnorm._check(torch.zeros(4, 16, dtype=x_dtype), torch.zeros(16, dtype=w_dtype))
    for x_ok in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match="CUDA"):
            rmsnorm._check(torch.zeros(4, 16, dtype=x_ok), torch.zeros(16))
    assert rmsnorm.RMS_NORM.launches == before
