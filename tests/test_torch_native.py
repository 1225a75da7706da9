"""The port's native binding and its fault-tolerant control loop on the CPU:
the native build, a lighthouse with two port Managers (one per replica
group, in threads), quorum, averaged allreduce, the commit vote, a late
group healing over HTTPTransport, and the copy-on-send snapshot."""

from __future__ import annotations

import threading
from datetime import timedelta

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch import _build, _native
from torchft_tpu_torch.checkpointing import HTTPTransport
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.metrics import MetricsLogger
from torchft_tpu_torch.obs.spans import SpanTracker

HOST = "127.0.0.1"
TIMEOUT = timedelta(seconds=30)


def test_method_ids_and_status_codes_match_the_jax_binding() -> None:
    """Copied, not imported: both bindings must name the same wire ids so
    mixed JAX/torch quorums stay possible."""
    ref = import_reference("torchft_tpu._native")
    names = [n for n in dir(ref) if n.isupper() and isinstance(getattr(ref, n), int)
             and n.split("_")[0] in ("LIGHTHOUSE", "MANAGER", "STORE")]
    assert len(names) >= 17
    for n in names:
        assert getattr(_native, n) == getattr(ref, n), n
    for n in ("_OK", "_CANCELLED", "_DEADLINE_EXCEEDED"):
        assert getattr(_native, n) == getattr(ref, n), n
    assert _build.NATIVE_SOURCES == tuple(ref.NATIVE_SOURCES)


def test_store_round_trip_and_errors() -> None:
    server = _native.StoreServer(bind=f"{HOST}:0")
    try:
        client = _native.StoreClient(server.address() + "/pre")
        client.set("k", b"\x00v")
        assert client.get("k") == b"\x00v"
        assert client.get("missing", wait=False) is None
        assert client.add("n", 5) == 5 and client.add("n", -7) == -2
        client.delete("k")
        assert client.get("k", wait=False) is None
        with pytest.raises(TimeoutError):
            client.get("never", wait=True, timeout_ms=200)
        client.close()
    finally:
        server.shutdown()


def _manager(lighthouse: str, group: int, state: dict, min_replicas: int = 1,
             init_sync: bool = True, use_async_quorum: bool = True,
             collective=None) -> Manager:
    def load(sd):
        state["w"].copy_(sd["w"])

    return Manager(
        collective=collective or TCPCollective(timeout=30.0, host=HOST),
        use_async_quorum=use_async_quorum,
        load_state_dict=load,
        state_dict=lambda: {"w": state["w"]},
        min_replica_size=min_replicas,
        rank=0,
        world_size=1,
        replica_id=f"test_g{group}",
        lighthouse_addr=lighthouse,
        store_addr=HOST,
        manager_bind=f"{HOST}:0",
        checkpoint_transport=HTTPTransport(timeout=30.0, host=HOST),
        init_sync=init_sync,
        timeout=TIMEOUT,
        quorum_timeout=TIMEOUT,
    )


def _run_threads(fns) -> list:
    out = [None] * len(fns)
    errs = []

    def wrap(i, fn):
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    threads = [threading.Thread(target=wrap, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a replica thread hung"
    if errs:
        raise errs[0]
    return out


def test_two_managers_quorum_allreduce_commit() -> None:
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=2,
                                  join_timeout_ms=100)
    states = [{"w": torch.zeros(4)} for _ in range(2)]
    # init_sync=False: both groups start as peers (with it, step 0 would
    # make group 1 heal from group 0 and sit the step out).
    managers = [_manager(lh.address(), g, states[g], min_replicas=2, init_sync=False)
                for g in range(2)]
    try:
        def step(g: int):
            m = managers[g]
            results = []
            for s in range(2):
                m.start_quorum()
                grad = torch.arange(6, dtype=torch.float32) * (g + 1) + s
                avg = m.allreduce(grad).result()
                results.append((avg, m.num_participants(), m.should_commit()))
            return results

        r0, r1 = _run_threads([lambda: step(0), lambda: step(1)])
        for s in range(2):
            want = torch.arange(6, dtype=torch.float32) * 1.5 + s
            for avg, n, committed in (r0[s], r1[s]):
                assert n == 2 and committed
                assert torch.equal(avg, want)
            # Both groups get identical bytes from the ring.
            assert torch.equal(r0[s][0], r1[s][0])
        assert managers[0].current_step() == managers[1].current_step() == 2
        assert managers[0].batches_committed() == 4
    finally:
        for m in managers:
            m.shutdown()
        lh.shutdown()


@pytest.mark.parametrize("use_async_quorum", [True, False])
def test_late_group_heals_over_http(use_async_quorum: bool) -> None:
    """Async quorum: the healing group sits its first step out (sends
    zeros) and installs the fetched state at the vote.  Sync quorum: it
    installs the state before the step and takes part in it."""
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=1,
                                  join_timeout_ms=100)
    s0 = {"w": torch.zeros(3)}
    s1 = {"w": torch.full((3,), -9.0)}
    ring0 = TCPCollective(timeout=30.0, host=HOST)
    m0 = _manager(lh.address(), 0, s0, use_async_quorum=use_async_quorum, collective=ring0)
    m1 = None
    try:
        # Group 0 alone: two committed steps, each adding 1 to its weights.
        for _ in range(2):
            m0.start_quorum()
            assert m0.should_commit()
            s0["w"] += 1.0
        m1 = _manager(lh.address(), 1, s1, use_async_quorum=use_async_quorum)

        def group0():
            # Solo steps until group 1 is in the ring, then the heal step
            # and one more, in lockstep with group 1.
            joined = 0
            while joined < 2:
                m0.start_quorum()
                grad = m0.allreduce(torch.ones(3)).result()
                assert m0.should_commit()
                s0["w"] += grad
                joined += ring0.size() == 2

        def group1():
            m1.start_quorum()
            grad = m1.allreduce(torch.full((3,), 100.0)).result()
            assert m1.num_participants() == (1 if use_async_quorum else 2)
            assert m1.should_commit()
            # The heal installed group 0's state at its step; both groups
            # then apply the same average.
            assert m1.current_step() >= 3
            s1["w"] += grad
            m1.start_quorum()
            grad = m1.allreduce(torch.ones(3)).result()
            assert m1.num_participants() == 2 and m1.should_commit()
            s1["w"] += grad

        _run_threads([group0, group1])
        assert m0.current_step() == m1.current_step()
        assert torch.equal(s0["w"], s1["w"]), (s0["w"], s1["w"])
    finally:
        for m in (m0, m1):
            if m is not None:
                m.shutdown()
        lh.shutdown()


def test_served_snapshot_is_a_copy_taken_at_send() -> None:
    """Torch optimizers update parameters in place: what a donor serves
    must stay the bytes of the step it snapshotted."""
    donor, healer = HTTPTransport(timeout=10.0, host=HOST), HTTPTransport(timeout=10.0, host=HOST)
    try:
        w = torch.arange(8, dtype=torch.float32)
        b = torch.ones(2, dtype=torch.bfloat16)
        donor.send_checkpoint([1], step=5, state_dict={"w": w, "b": b, "n": 3}, timeout=10.0)
        w.mul_(100.0)  # the optimizer step after the snapshot
        b.zero_()
        got = healer.recv_checkpoint(0, donor.metadata(), step=5, timeout=10.0)
        assert torch.equal(got["w"], torch.arange(8, dtype=torch.float32))
        assert torch.equal(got["b"], torch.ones(2, dtype=torch.bfloat16)) and got["n"] == 3
        donor.disallow_checkpoint()
        with pytest.raises(Exception):
            healer.recv_checkpoint(0, donor.metadata(), step=6, timeout=1.0)
    finally:
        donor.shutdown()
        healer.shutdown()


def test_tcp_collective_ring_of_three_sums_in_ring_order() -> None:
    server = _native.StoreServer(bind=f"{HOST}:0")
    cols = [TCPCollective(timeout=20.0, host=HOST) for _ in range(3)]
    rng = np.random.default_rng(0)
    data = [rng.standard_normal(1001).astype(np.float32) for _ in range(3)]
    try:
        _run_threads([
            (lambda r=r: cols[r].configure(server.address() + "/ring", r, 3)) for r in range(3)
        ])
        outs = _run_threads([(lambda r=r: cols[r].allreduce([data[r]], op="avg").wait(20))
                             for r in range(3)])
        for o in outs:
            assert np.array_equal(o[0], outs[0][0])
        np.testing.assert_allclose(outs[0][0], sum(data) / 3, rtol=1e-6, atol=1e-6)
    finally:
        for c in cols:
            c.shutdown()
        server.shutdown()


def test_commit_gate_holds_the_optimizer_and_max_retries_raises() -> None:
    """A group below min_replica_size votes no: the wrapped optimizer does
    not step, and past max_retries the vote raises."""
    from torchft_tpu_torch.manager import ExceededMaxRetriesError
    from torchft_tpu_torch.optim import Optimizer

    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=1,
                                  join_timeout_ms=100)
    w = torch.nn.Parameter(torch.ones(3))
    manager = Manager(
        collective=TCPCollective(timeout=10.0, host=HOST), load_state_dict=None,
        state_dict=None, min_replica_size=2, rank=0, world_size=1, replica_id="gate",
        lighthouse_addr=lh.address(), store_addr=HOST, manager_bind=f"{HOST}:0",
        timeout=TIMEOUT, quorum_timeout=TIMEOUT, max_retries=1,
    )
    opt = Optimizer(manager, torch.optim.SGD([w], lr=0.5))
    try:
        opt.zero_grad()
        w.grad = torch.ones(3)
        assert opt.step() is False
        assert torch.equal(w.detach(), torch.ones(3)) and manager.current_step() == 0
        opt.zero_grad()
        w.grad = torch.ones(3)
        with pytest.raises(ExceededMaxRetriesError):
            opt.step()
    finally:
        manager.shutdown()
        lh.shutdown()


def test_gradient_averager_packs_and_unpacks_buckets() -> None:
    from torchft_tpu_torch.ddp import GradientAverager, plan_buckets
    from torchft_tpu_torch.futures import completed_future

    f32 = torch.float32
    plan = plan_buckets([((10,), f32), ((10,), f32), ((30,), f32), ((1,), f32)], bucket_bytes=80)
    assert [b.indices for b in plan] == [[0, 1], [2], [3]]

    class Ring:
        wire_dtype = "f32"

        def size(self):
            return 2

    class HalvingManager:
        calls = 0
        timeout = TIMEOUT
        spans = SpanTracker(MetricsLogger(None))

        def current_step(self):
            return 0

        def note_d2h(self, nbytes):
            pass

        def note_h2d(self, nbytes):
            pass

        def allreduce(self, flat, allow_wire_compression=True, donate=False):
            HalvingManager.calls += 1
            assert flat.dtype == torch.float32 and donate
            return completed_future(flat * 0.5)

        def wait_quorum(self):
            pass

        def errored(self):
            return None

        def collective(self):
            return Ring()

        def is_participating(self):
            return True

        def num_participants(self):
            return 2

    # Grouped by dtype: the bf16 gradient (widened to f32 on the host) in
    # one bucket, the two f32 gradients (40 bytes) in the other.
    grads = [torch.arange(6, dtype=torch.float32).reshape(2, 3), torch.ones(4),
             torch.full((5,), 3.0, dtype=torch.bfloat16)]
    want = [g.float() * 0.5 for g in grads]
    GradientAverager(HalvingManager(), bucket_bytes=40).allreduce(grads)
    assert HalvingManager.calls == 2
    for g, w in zip(grads, want):
        assert torch.equal(g.float(), w)
