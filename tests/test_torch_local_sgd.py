"""The port's LocalSGD and DiLoCo wrappers: the twins of the JAX package's
``tests/test_wrappers.py`` LocalSGD/DiLoCo cases (a stand-in Manager: call
patterns and the sync arithmetic) and of ``tests/test_local_sgd_integ.py``
(replica groups as threads on a real lighthouse and TCP ring, one killed
mid-run and restarted, healing from the survivor: every group's post-sync
parameters, and DiLoCo's backup, bitwise equal).  Also the port's
``PerLeafGradientAverager`` against the JAX package's on a mixed quorum.
"""

from __future__ import annotations

import logging
import threading
import time
from datetime import timedelta
from typing import Any, Dict, List
from unittest.mock import create_autospec

import numpy as np
import pytest
import torch

from harness import FailureInjector, Runner, run_replicas
from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing import HTTPTransport
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.ddp import PerLeafGradientAverager
from torchft_tpu_torch.futures import completed_future
from torchft_tpu_torch.local_sgd import DiLoCo, LocalSGD
from torchft_tpu_torch.manager import ExceededMaxRetriesError, Manager
from torchft_tpu_torch.metrics import MetricsLogger
from torchft_tpu_torch.obs.spans import SpanTracker
from torchft_tpu_torch.semisync import outer

logging.basicConfig(level=logging.INFO)

HOST = "127.0.0.1"


def _mock_manager(num_participants: int = 2, commit: bool = True):
    """tests/test_wrappers.py's stand-in: an autospec Manager whose
    allreduce returns its input (every participant contributed the same
    values, so the average is the input)."""
    manager = create_autospec(Manager, instance=True)
    manager.num_participants.return_value = num_participants
    manager.should_commit.return_value = commit
    manager._use_async_quorum = False
    manager.timeout = timedelta(seconds=60)
    manager.spans = SpanTracker(MetricsLogger(None))
    manager.metrics = MetricsLogger(None)
    manager.errored.return_value = None
    manager.current_step.return_value = 0

    def fake_allreduce(arr, should_average=True, allow_wire_compression=True, wire_codec=None,
                       donate=False):
        out = arr.clone() if isinstance(arr, torch.Tensor) else np.array(arr, copy=True)
        return completed_future(out)

    manager.allreduce.side_effect = fake_allreduce
    return manager


class _ParamBox:
    """A model's parameters as a list of tensors; ``set`` copies in place."""

    def __init__(self, *tensors: torch.Tensor) -> None:
        self.params = list(tensors)

    def get(self) -> List[torch.Tensor]:
        return self.params

    def set(self, new: List[Any]) -> None:
        for p, n in zip(self.params, new):
            p.copy_(torch.as_tensor(n))


# -- LocalSGD ------------------------------------------------------------------


def test_local_sgd_syncs_every_n() -> None:
    manager = _mock_manager()
    box = _ParamBox(torch.ones(4))
    with LocalSGD(manager, box.get, box.set, sync_every=2) as lsgd:
        lsgd.step()
        manager.start_quorum.assert_not_called()
        lsgd.step()
        manager.start_quorum.assert_called_once()
        manager.should_commit.assert_called_once()


def test_local_sgd_commit_gates_copyback() -> None:
    manager = _mock_manager(commit=False)
    manager.allreduce.side_effect = lambda arr, **kw: completed_future(torch.zeros_like(arr))
    box = _ParamBox(torch.ones(4))
    with LocalSGD(manager, box.get, box.set, sync_every=1) as lsgd:
        lsgd.step()
    # Failed commit: params untouched though the allreduce returned zeros.
    torch.testing.assert_close(box.params[0], torch.ones(4), rtol=0, atol=0)


def test_local_sgd_averages_parameters_full_width() -> None:
    manager = _mock_manager()
    seen = []
    manager.allreduce.side_effect = lambda arr, **kw: (seen.append(kw), completed_future(
        arr * 0.5))[1]
    box = _ParamBox(torch.full((3,), 4.0), torch.full((2, 2), 2.0))
    LocalSGD(manager, box.get, box.set, sync_every=1).step()
    assert [kw["allow_wire_compression"] for kw in seen] == [False, False]
    assert torch.equal(box.params[0], torch.full((3,), 2.0))
    assert torch.equal(box.params[1], torch.full((2, 2), 1.0))


# -- DiLoCo --------------------------------------------------------------------


def test_diloco_requires_sync_quorum() -> None:
    manager = _mock_manager()
    manager._use_async_quorum = True
    box = _ParamBox(torch.ones(2))
    with pytest.raises(ValueError, match="synchronous quorum"):
        DiLoCo(manager, box.get, box.set, outer.sgd(0.5), sync_every=1)


def test_diloco_outer_step_moves_toward_local_progress() -> None:
    manager = _mock_manager()
    box = _ParamBox(torch.zeros(2))
    diloco = DiLoCo(manager, box.get, box.set, outer.sgd(1.0), sync_every=1)
    # Inner training moved w to 1; pseudogradient = backup - local = -1.
    box.params[0].fill_(1.0)
    diloco.step()
    # Outer SGD at lr 1: backup <- 0 - 1 * (-1) = 1, the local progress.
    assert torch.equal(box.params[0], torch.ones(2))
    assert torch.equal(diloco.backup_params[0], torch.ones(2))


def test_diloco_failed_commit_restores_backup() -> None:
    manager = _mock_manager(commit=False)
    box = _ParamBox(torch.zeros(2))
    diloco = DiLoCo(manager, box.get, box.set, outer.sgd(1.0), sync_every=1)
    box.params[0].fill_(1.0)
    diloco.step()
    assert torch.equal(box.params[0], torch.zeros(2))


def test_diloco_sync_counts_reset() -> None:
    manager = _mock_manager()
    box = _ParamBox(torch.zeros(2))
    diloco = DiLoCo(manager, box.get, box.set, outer.sgd(0.5), sync_every=3)
    for _ in range(3):
        diloco.step()
    assert manager.start_quorum.call_count == 1
    for _ in range(3):
        diloco.step()
    assert manager.start_quorum.call_count == 2


@pytest.mark.parametrize("algo", ["local_sgd", "diloco"])
def test_sync_error_latches_and_resets_cadence(algo) -> None:
    manager = _mock_manager()
    manager.start_quorum.side_effect = RuntimeError("quorum died")
    box = _ParamBox(torch.ones(4))
    impl = (LocalSGD(manager, box.get, box.set, sync_every=2) if algo == "local_sgd"
            else DiLoCo(manager, box.get, box.set, outer.sgd(0.5), sync_every=2))
    impl.step()
    impl.step()  # the sync: the quorum failure must not raise
    assert getattr(impl, "_impl", impl)._local_step == 0
    manager.report_error.assert_called()


@pytest.mark.parametrize("algo", ["local_sgd", "diloco"])
def test_sync_max_retries_still_propagates(algo) -> None:
    manager = _mock_manager()
    manager.should_commit.side_effect = ExceededMaxRetriesError("give up")
    box = _ParamBox(torch.ones(4))
    impl = (LocalSGD(manager, box.get, box.set, sync_every=1) if algo == "local_sgd"
            else DiLoCo(manager, box.get, box.set, outer.sgd(0.5), sync_every=1))
    with pytest.raises(ExceededMaxRetriesError):
        impl.step()


# -- PerLeafGradientAverager ------------------------------------------------------


def test_per_leaf_averager_alone_returns_inputs_and_places_results() -> None:
    manager = _mock_manager()
    manager.collective.return_value.size.return_value = 1
    manager.is_participating.return_value = True
    leaves = [torch.ones(3), torch.zeros(2)]
    assert PerLeafGradientAverager(manager).allreduce(leaves) == leaves
    manager.allreduce.assert_not_called()
    manager.collective.return_value.size.return_value = 2
    manager.allreduce.side_effect = lambda arr, **kw: completed_future(np.asarray(arr) * 2)
    out = PerLeafGradientAverager(manager).allreduce(leaves)
    assert all(isinstance(t, torch.Tensor) for t in out)
    assert torch.equal(out[0], torch.full((3,), 2.0))


def test_per_leaf_averager_matches_the_jax_one_in_a_mixed_quorum() -> None:
    """A JAX group and a port group average the same leaves per leaf over
    one ring: results bitwise equal on both."""
    ref = {n: import_reference(f"torchft_tpu.{n}") for n in ("manager", "collectives", "ddp")}
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=2, join_timeout_ms=100)
    timeout = timedelta(seconds=30)
    out: Dict[int, List[np.ndarray]] = {}

    def leaves(g: int) -> List[np.ndarray]:
        rng = np.random.default_rng(300 + g)
        return [rng.standard_normal(s).astype(np.float32) for s in ((5, 7), (1001,), ())]

    def group(g: int) -> None:
        if g == 0:
            m = ref["manager"].Manager(
                collective=ref["collectives"].TCPCollective(timeout=30.0),
                load_state_dict=None, state_dict=None, min_replica_size=2, timeout=timeout,
                quorum_timeout=timeout, rank=0, world_size=1, replica_id="jax0",
                lighthouse_addr=lh.address(), init_sync=False)
        else:
            m = Manager(collective=TCPCollective(timeout=30.0, host=HOST), load_state_dict=None,
                        state_dict=None, min_replica_size=2, timeout=timeout,
                        quorum_timeout=timeout, rank=0, world_size=1, replica_id="port1",
                        lighthouse_addr=lh.address(), store_addr=HOST,
                        manager_bind=f"{HOST}:0", init_sync=False)
        try:
            m.start_quorum()
            if g == 0:
                res = ref["ddp"].PerLeafGradientAverager(m).allreduce(leaves(g))
                out[g] = [np.asarray(r) for r in res]
            else:
                res = PerLeafGradientAverager(m).allreduce(
                    [torch.from_numpy(a) for a in leaves(g)])
                out[g] = [r.numpy() for r in res]
            assert m.should_commit()
        finally:
            m.shutdown()

    threads = [threading.Thread(target=group, args=(g,)) for g in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90)
    finally:
        lh.shutdown()
    assert set(out) == {0, 1}
    for a, b, want in zip(out[0], out[1], leaves(1)):
        # The JAX collective hands a 0-d leaf back 1-d; the port keeps 0-d.
        assert b.shape == want.shape and a.size == b.size and a.tobytes() == b.tobytes()


# -- integration: replica groups as threads --------------------------------------


def _init_params() -> List[torch.Tensor]:
    return [torch.full((4, 8), 0.1), torch.zeros(8), torch.full((8, 2), -0.05)]


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((16, 2)).astype(np.float32)))


def _grads(params: List[torch.Tensor], x: torch.Tensor, y: torch.Tensor) -> List[torch.Tensor]:
    leaves = [p.detach().clone().requires_grad_(True) for p in params]
    h = torch.tanh(x @ leaves[0] + leaves[1])
    loss = ((h @ leaves[2] - y) ** 2).mean()
    return list(torch.autograd.grad(loss, leaves))


def local_sgd_train_loop(runner: Runner, rank: int) -> Dict[str, Any]:
    """One replica group running LocalSGD or DiLoCo (the port's twin of
    tests/test_local_sgd_integ.py's loop)."""
    algo_name = runner.train_loop_args.get("algo", "local_sgd")
    total_steps = runner.train_loop_args.get("total_steps", 4)
    sync_every = runner.train_loop_args.get("sync_every", 3)
    params = _init_params()
    box = _ParamBox(*params)
    manager = Manager(
        collective=TCPCollective(timeout=20.0, host=HOST),
        load_state_dict=lambda sd: box.set(sd["params"]),
        state_dict=lambda: {"params": box.params},
        min_replica_size=1,
        use_async_quorum=False,
        timeout=timedelta(seconds=20),
        quorum_timeout=timedelta(seconds=20),
        rank=0,
        world_size=1,
        replica_id=str(runner.replica_id),
        lighthouse_addr=runner.lighthouse_address,
        store_addr=HOST,
        manager_bind=f"{HOST}:0",
        checkpoint_transport=HTTPTransport(timeout=20.0, host=HOST),
    )
    if algo_name == "local_sgd":
        algo: Any = LocalSGD(manager, box.get, box.set, sync_every=sync_every)
    else:
        algo = DiLoCo(manager, box.get, box.set,
                      outer_tx=outer.sgd(0.7, momentum=0.9, nesterov=True),
                      sync_every=sync_every)
    history: Dict[int, List[np.ndarray]] = {}
    try:
        while manager.current_step() < total_steps:
            step = manager.current_step()
            for inner in range(sync_every):
                x, y = _batch(10000 * step + 100 * inner + runner.replica_id)
                grads = _grads(box.params, x, y)
                with torch.no_grad():
                    for p, g in zip(box.params, grads):
                        p.sub_(0.1 * g)
                algo.step()
            if manager.current_step() > step:
                history[manager.current_step()] = [p.numpy().copy() for p in box.params]
            runner.failure_injector.check(runner.replica_id, manager.current_step())
        barrier = runner.train_loop_args.get("barrier")
        if barrier is not None:
            barrier.wait(timeout=60)
        out: Dict[str, Any] = {"params": [p.numpy().copy() for p in box.params],
                               "step": manager.current_step(), "history": history}
        if algo_name == "diloco":
            out["backup"] = [t.numpy().copy() for t in algo.backup_params]
        return out
    finally:
        manager.shutdown()


class _DoneBarrier:
    """Waits (bounded) until every group has finished its loop, so no group
    shuts its servers down while a peer still needs them."""

    def __init__(self, parties: int) -> None:
        self._parties = parties
        self._done = 0
        self._cond = threading.Condition()

    def wait(self, timeout: float = 60) -> None:
        with self._cond:
            self._done += 1
            self._cond.notify_all()
            deadline = time.monotonic() + timeout
            while self._done < self._parties:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                self._cond.wait(timeout=remaining)


@pytest.fixture
def lighthouse():
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=2, join_timeout_ms=100)
    yield lh
    lh.shutdown()


def _run(lighthouse, injectors, **loop_args):
    barrier = _DoneBarrier(len(injectors))
    runners = [
        Runner(replica_id=i, lighthouse_address=lighthouse.address(), failure_injector=inj,
               train_loop=local_sgd_train_loop, num_replicas=len(injectors),
               train_loop_args={"barrier": barrier, **loop_args})
        for i, inj in enumerate(injectors)
    ]
    return run_replicas(runners)


def _assert_equal_lists(a: List[np.ndarray], b: List[np.ndarray]) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.tobytes() == y.tobytes()


def test_local_sgd_healthy(lighthouse) -> None:
    results = _run(lighthouse, [FailureInjector(), FailureInjector()])
    a, b = results[0][0], results[1][0]
    assert a["step"] >= 4 and b["step"] >= 4
    _assert_equal_lists(a["params"], b["params"])
    for step in set(a["history"]) & set(b["history"]):
        _assert_equal_lists(a["history"][step], b["history"][step])


def test_local_sgd_recovery(lighthouse) -> None:
    injector = FailureInjector().fail_at(1, 2)
    results = _run(lighthouse, [FailureInjector(), injector], total_steps=5)
    assert injector.count == 1
    a, b = results[0][0], results[1][0]
    assert a["step"] >= 5 and b["step"] >= 5
    _assert_equal_lists(a["params"], b["params"])


def test_diloco_healthy(lighthouse) -> None:
    results = _run(lighthouse, [FailureInjector(), FailureInjector()], algo="diloco")
    a, b = results[0][0], results[1][0]
    assert a["step"] >= 4 and b["step"] >= 4
    _assert_equal_lists(a["params"], b["params"])
    _assert_equal_lists(a["backup"], b["backup"])


def test_diloco_recovery(lighthouse) -> None:
    """A killed DiLoCo group heals the outer state with the model: after its
    restart its backup matches the survivor's and the syncs converge
    bitwise."""
    injector = FailureInjector().fail_at(1, 2)
    results = _run(lighthouse, [FailureInjector(), injector], algo="diloco", total_steps=5)
    assert injector.count == 1
    a, b = results[0][0], results[1][0]
    assert a["step"] >= 5 and b["step"] >= 5
    _assert_equal_lists(a["params"], b["params"])
    _assert_equal_lists(a["backup"], b["backup"])
