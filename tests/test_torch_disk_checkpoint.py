"""The port's durable disk checkpoints against the JAX package's.

- Twins of the nine cases of ``tests/test_disk_checkpoint.py``: a round
  trip and the latest step, retention, a torn file and a ``.tmp`` skipped,
  a cold start, the placement restore (the template's device is kept; a
  twin of another dtype or shape raises), a write failure raised from the
  next ``wait``, ``ManagedDiskCheckpoint``'s cadence and exact Manager
  bookkeeping, its ``shutdown`` that never raises, and backpressure.
- The same save sequence gives the same file names and the same retention
  in both packages.
- A JAX package frame in the directory raises ``ForeignFrameError`` in the
  port's ``restore_latest``, while the JAX package skips a frame it cannot
  read (the port's) and, by the step number, retains the foreign file over
  its own newer save.
- ``ManagedDiskCheckpoint`` over a real port Manager on a real lighthouse,
  with the quorum stubbed: a restart resumes its step, its committed
  batches and the user state.

Tensors come from seeded torch generators; the JAX package's trees from
numpy generators with the same seeds.
"""

from __future__ import annotations

import os
import threading
from datetime import timedelta
from typing import Any, Dict, List
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from torch_port_ref import cuda_device, import_reference  # noqa: F401 - fixture
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing import DiskCheckpointer, ManagedDiskCheckpoint
from torchft_tpu_torch.checkpointing.serialization import (
    ForeignFrameError,
    flatten_state_dict,
    sharding_restorer,
)
from torchft_tpu_torch.collectives import DummyCollective
from torchft_tpu_torch.manager import Manager

HOST = "127.0.0.1"


def _tree(seed: int = 0) -> Dict[str, Any]:
    g = torch.Generator().manual_seed(seed)
    return {
        "w": torch.randn(8, 16, generator=g),
        "b16": torch.randn(4, 4, generator=g).to(torch.bfloat16),
        "host": torch.randn(7, generator=g, dtype=torch.float64),
        "count": torch.tensor(seed, dtype=torch.int32),
        "step_obj": 3,
    }


def _leaves(tree: Any) -> List[Any]:
    meta, buffers = flatten_state_dict(tree)
    return [("t", meta.tensors[v], buffers[v].tobytes()) if k == "tensor" else ("o", v)
            for k, v in meta.leaves]


def _assert_tree_equal(a: Any, b: Any) -> None:
    assert _leaves(a) == _leaves(b)


def test_roundtrip_and_latest(tmp_path) -> None:
    ckpt = DiskCheckpointer(str(tmp_path))
    try:
        ckpt.save(5, _tree(0))
        ckpt.save(10, _tree(1))
        ckpt.wait()
        assert ckpt.steps() == [5, 10] and ckpt.latest_step() == 10
        step, sd = ckpt.restore_latest()
        assert step == 10
        _assert_tree_equal(sd, _tree(1))
        _assert_tree_equal(ckpt.restore(5), _tree(0))
        assert sd["w"].device.type == "cpu"
        assert ckpt.last_save["step"] == 10 and ckpt.last_save["write_ms"] >= 0.0
    finally:
        ckpt.shutdown()


def test_retention_keeps_newest(tmp_path) -> None:
    ckpt = DiskCheckpointer(str(tmp_path), keep=2)
    try:
        for s in (1, 2, 3, 4):
            ckpt.save(s, _tree(s))
        ckpt.wait()
        assert ckpt.steps() == [3, 4]
    finally:
        ckpt.shutdown()


def test_torn_and_tmp_files_skipped(tmp_path) -> None:
    ckpt = DiskCheckpointer(str(tmp_path))
    try:
        ckpt.save(7, _tree(0))
        ckpt.wait()
        # A torn write of a crashed process, named as the newest, and the
        # frame of step 7 cut inside its buffers, named as step 8.
        with open(tmp_path / "step_000000000009.tpuft", "wb") as f:
            f.write(b"\x00" * 16)
        whole = (tmp_path / "step_000000000007.tpuft").read_bytes()
        (tmp_path / "step_000000000008.tpuft").write_bytes(whole[: len(whole) - 100])
        # A temporary file in flight is invisible to restore.
        with open(tmp_path / "step_000000000011.tpuft.tmp", "wb") as f:
            f.write(b"garbage")
        assert ckpt.steps() == [7, 8, 9]
        step, sd = ckpt.restore_latest()
        assert step == 7
        _assert_tree_equal(sd, _tree(0))
    finally:
        ckpt.shutdown()


def test_cold_start_returns_none(tmp_path) -> None:
    ckpt = DiskCheckpointer(str(tmp_path))
    try:
        assert ckpt.restore_latest() == (None, None)
        assert ckpt.latest_step() is None
    finally:
        ckpt.shutdown()


def test_restore_places_each_tensor_on_its_live_twins_device(tmp_path) -> None:
    """The placement restore: with the live state as the template, each
    restored tensor lands on its twin's device (``meta`` here stands for a
    device other than the file's; the card's case is the gpu test below),
    a tensor with no twin stays on the CPU, and a twin of another dtype or
    shape raises."""
    ckpt = DiskCheckpointer(str(tmp_path))
    try:
        ckpt.save(3, {"model": {"w": torch.arange(64.0).reshape(8, 8)}, "extra": torch.ones(2)})
        ckpt.wait()
        live = {"model": {"w": torch.empty(8, 8, device="meta")}}
        step, sd = ckpt.restore_latest(template_fn=lambda: live)
        assert step == 3
        assert sd["model"]["w"].device.type == "meta" and sd["extra"].device.type == "cpu"
        np.testing.assert_array_equal(ckpt.restore(3)["model"]["w"].numpy(),
                                      np.arange(64.0, dtype=np.float32).reshape(8, 8))
        # The Manager's wrapper: the twin at the longest trailing path.
        restore = sharding_restorer(lambda: {"w": torch.empty(8, 8, device="meta")})
        assert restore(("user", "default", "w"), torch.zeros(8, 8)).device.type == "meta"
        for bad in (torch.empty(8, 8, dtype=torch.float64), torch.empty(4, 16)):
            with pytest.raises(ValueError, match="live twin"):
                ckpt.restore(3, template_fn=lambda bad=bad: {"model": {"w": bad}})
    finally:
        ckpt.shutdown()


@pytest.mark.gpu
def test_restore_lands_on_the_card(tmp_path, cuda_device) -> None:
    ckpt = DiskCheckpointer(str(tmp_path))
    try:
        live = {"w": torch.arange(16.0, device=cuda_device)}
        ckpt.save(1, live)
        ckpt.wait()
        _, sd = ckpt.restore_latest(template_fn=lambda: live)
        assert sd["w"].device == live["w"].device
        assert torch.equal(sd["w"], live["w"])
    finally:
        ckpt.shutdown()


def test_write_failure_surfaces_on_next_save(tmp_path) -> None:
    ckpt = DiskCheckpointer(str(tmp_path))
    try:
        ckpt.save(1, _tree(0))
        ckpt.wait()
        ckpt._dir = str(tmp_path / "gone" / "deeper")
        ckpt.save(2, _tree(1))
        with pytest.raises((RuntimeError, TimeoutError)):
            ckpt.wait(timeout=10.0)
    finally:
        ckpt._dir = str(tmp_path)
        ckpt._error = None
        ckpt.shutdown()


class _FakeManager:
    def __init__(self) -> None:
        self.step = 0
        self.batches = 0
        self.loaded = None

    def current_step(self) -> int:
        return self.step

    def state_dict(self) -> Dict[str, int]:
        return {"step": self.step, "batches_committed": self.batches}

    def load_state_dict(self, sd: Dict[str, int]) -> None:
        self.loaded = sd
        self.step = sd["step"]
        self.batches = sd["batches_committed"]


def test_managed_wiring_roundtrip(tmp_path) -> None:
    mgr = _FakeManager()
    user = {"params": torch.arange(4.0)}
    applied: Dict[str, Any] = {}
    mdc = ManagedDiskCheckpoint(mgr, lambda: user, applied.update, str(tmp_path), every=10)
    assert mdc.restore() is None
    for step, batches, committed in [(9, 17, True), (10, 23, True), (11, 24, False)]:
        mgr.step, mgr.batches = step, batches
        mdc.maybe_save(committed)
    mgr.step, mgr.batches = 20, 41
    mdc.maybe_save(True)
    mdc.shutdown()
    assert DiskCheckpointer(str(tmp_path)).steps() == [10, 20]

    mgr2 = _FakeManager()
    mdc2 = ManagedDiskCheckpoint(mgr2, lambda: user, applied.update, str(tmp_path))
    assert mdc2.restore() == 20
    assert mgr2.step == 20 and mgr2.batches == 41
    assert torch.equal(applied["params"], torch.arange(4.0))
    mdc2.shutdown()


def test_managed_shutdown_never_raises(tmp_path) -> None:
    mgr = _FakeManager()
    mdc = ManagedDiskCheckpoint(mgr, lambda: {"x": torch.zeros(2)}, lambda sd: None,
                                str(tmp_path), every=1)
    mgr.step = 1
    mdc.maybe_save(True)
    mdc.checkpointer.wait()
    mdc.checkpointer._dir = str(tmp_path / "gone" / "deeper")
    mgr.step = 2
    mdc.maybe_save(True)
    mdc.shutdown()


def test_backpressure_orders_saves(tmp_path) -> None:
    ckpt = DiskCheckpointer(str(tmp_path), keep=10)
    try:
        done = threading.Event()

        def saver() -> None:
            for s in range(1, 6):
                ckpt.save(s, _tree(s))
            done.set()

        t = threading.Thread(target=saver)
        t.start()
        t.join(timeout=30)
        assert done.is_set() and not t.is_alive()
        ckpt.wait(timeout=30)
        assert ckpt.steps() == [1, 2, 3, 4, 5]
        assert ckpt.last_save["stall_ms"] >= 0.0
    finally:
        ckpt.shutdown()


# -- against the JAX package -------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_disk():
    return import_reference("torchft_tpu.checkpointing.disk")


def _np_tree(seed: int) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 16)).astype(np.float32), "n": seed}


@pytest.mark.parametrize("keep", [1, 2, 3])
def test_same_saves_give_the_same_files_and_retention_in_both_packages(
        tmp_path, jax_disk, keep) -> None:
    steps = [int(s) for s in np.random.default_rng(40 + keep).choice(5000, size=6,
                                                                       replace=False)]
    steps = sorted(steps[:3]) + steps[3:]  # in order, then out of order
    listings = {}
    for name, make, tree in (("port", DiskCheckpointer, _tree),
                             ("jax", jax_disk.DiskCheckpointer, _np_tree)):
        d = tmp_path / name
        ckpt = make(str(d), keep=keep)
        seen = []
        try:
            for s in steps:
                ckpt.save(s, tree(s))
                ckpt.wait()
                seen.append((sorted(os.listdir(d)), ckpt.steps(), ckpt.latest_step()))
        finally:
            ckpt.shutdown()
        listings[name] = seen
    assert listings["port"] == listings["jax"]
    assert all(not n.endswith(".tmp") for names, _, _ in listings["port"] for n in names)


def test_a_jax_frame_raises_in_the_port_while_the_jax_package_skips(tmp_path, jax_disk) -> None:
    # The port's directory holds a JAX frame as its newest file.
    a = tmp_path / "a"
    jax_ckpt = jax_disk.DiskCheckpointer(str(a))
    jax_ckpt.save(9, _np_tree(9))
    jax_ckpt.shutdown()
    port = DiskCheckpointer(str(a))
    port.save(3, _tree(3))
    port.wait()
    with pytest.raises(ForeignFrameError, match="torchft_tpu.checkpointing.serialization"):
        port.restore_latest()
    port.shutdown()
    step, sd = jax_disk.DiskCheckpointer(str(a)).restore_latest()
    assert step == 9 and sd["n"] == 9

    # The JAX package over a port frame: it skips the file it cannot read
    # and resumes from an older one of its own.
    b = tmp_path / "b"
    port = DiskCheckpointer(str(b))
    port.save(9, _tree(9))
    port.shutdown()
    jax_ckpt = jax_disk.DiskCheckpointer(str(b), keep=1)
    jax_ckpt.save(3, _np_tree(3))
    jax_ckpt.wait()
    # Its retention keeps the newest step by number, the foreign file, and
    # deletes the save it just made.
    assert jax_ckpt.steps() == [9]
    assert jax_ckpt.restore_latest() == (None, None)
    jax_ckpt.shutdown()
    step, sd = DiskCheckpointer(str(b)).restore_latest()
    assert step == 9
    _assert_tree_equal(sd, _tree(9))


# -- over a real Manager -----------------------------------------------------------------


@pytest.fixture
def lighthouse():
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1)
    yield lh.address()
    lh.shutdown()


def _stub_manager(lighthouse: str, state: Dict[str, Any]) -> Manager:
    m = Manager(
        collective=DummyCollective(), load_state_dict=state.update, state_dict=lambda: state,
        min_replica_size=1, rank=0, world_size=1, replica_id="disk", lighthouse_addr=lighthouse,
        store_addr=HOST, manager_bind=f"{HOST}:0", timeout=timedelta(seconds=10),
        quorum_timeout=timedelta(seconds=10),
    )
    m._client = MagicMock()
    m._client._quorum.side_effect = lambda **kw: _native.QuorumResult(
        quorum_id=1, replica_rank=0, replica_world_size=1, store_address="",
        max_step=kw["step"], max_replica_rank=0, max_world_size=1, heal=False,
        recover_src_replica_rank=None, recover_src_manager_address="",
        recover_src_replica_ranks=[], recover_src_manager_addresses=[],
        participant_replica_ranks=[0], participant_manager_addresses=["self"],
    )
    m._client.should_commit.side_effect = lambda rank, step, ok, **kw: ok
    return m


def test_managed_checkpoint_over_a_real_manager_resumes_its_step(tmp_path, lighthouse) -> None:
    state = {"w": torch.zeros(5)}
    m = _stub_manager(lighthouse, state)
    mdc = ManagedDiskCheckpoint(m, lambda: state, state.update, str(tmp_path), every=2, keep=2)
    try:
        assert mdc.restore() is None
        for _ in range(5):
            m.start_quorum()
            state["w"] = state["w"] + 1.0
            committed = m.should_commit()
            assert committed
            mdc.maybe_save(committed)
        assert m.current_step() == 5
    finally:
        mdc.shutdown()
        m.shutdown()
    assert DiskCheckpointer(str(tmp_path)).steps() == [2, 4]

    state2 = {"w": torch.full((5,), -1.0)}
    m2 = _stub_manager(lighthouse, state2)
    mdc2 = ManagedDiskCheckpoint(m2, lambda: state2, state2.update, str(tmp_path), every=2)
    try:
        assert mdc2.restore() == 4
        assert m2.current_step() == 4 and m2.state_dict()["batches_committed"] == 4
        assert torch.equal(state2["w"], torch.full((5,), 4.0))
        m2.start_quorum()
        m2.wait_quorum()
        assert m2._client._quorum.call_args.kwargs["step"] == 4
        assert m2.should_commit() and m2.current_step() == 5
    finally:
        mdc2.shutdown()
        m2.shutdown()
