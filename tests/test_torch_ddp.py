"""The port's pipelined ``GradientAverager`` and ``Manager.allreduce`` against
the JAX package's.

- Averager parity: two port groups and two JAX groups (threads, a
  lighthouse each) average the same numpy gradients over 2-lane rings;
  results bitwise equal, ``last_stats`` bytes equal, on the f32 wire, the
  bf16 wire, and the bf16 wire with device wire prep.
- Device wire prep: the bf16 buffer handed to the collective is bitwise the
  ``ml_dtypes`` host cast of the gradients, and the bytes off the device
  halve while the wire bytes stay the host-cast path's.
- Mixed quorum: a JAX Manager and a port Manager on one lighthouse take
  three steps of allreduce + averager + ``should_commit``, bitwise equal.
- Pipelining and failure, with a stand-in Manager: every bucket is issued
  before the first is awaited, and a failed bucket leaves its gradients.
- On the card (``gpu``): two port groups average CUDA gradients through
  the side-stream copies, bitwise the host average.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future
from datetime import timedelta
from typing import Any, Callable, Dict, List

import numpy as np
import pytest
import torch

from torch_port_ref import cuda_device, import_reference  # noqa: F401 - fixture
from torchft_tpu_torch import _native
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.ddp import GradientAverager
from torchft_tpu_torch.futures import completed_future
from torchft_tpu_torch.manager import Manager

HOST = "127.0.0.1"
TIMEOUT = timedelta(seconds=30)
CHUNK = 4 << 10
BUCKET = 16 << 10
STAT_KEYS = ("buckets", "d2h_bytes", "h2d_bytes", "wire_bytes")


def _grads(gid: int) -> List[np.ndarray]:
    """Several buckets' worth of f32 gradients, one larger than a bucket,
    and a 0-d one (a loss riding along)."""
    rng = np.random.default_rng(50 + gid)
    shapes = [(64, 33), (6000,), (17,), (3, 5, 7), (2500,), ()]
    return [np.asarray(rng.standard_normal(s) * (gid + 1), dtype=np.float32) for s in shapes]


def _run_threads(fns: List[Callable[[], Any]]) -> List[Any]:
    out: List[Any] = [None] * len(fns)
    errs: List[BaseException] = []

    def wrap(i: int, fn) -> None:
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
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


def _jax_manager(ref, lighthouse: str, gid: int, wire: str):
    return ref["manager"].Manager(
        collective=ref["collectives"].TCPCollective(timeout=30.0, wire_dtype=wire,
                                                    chunk_bytes=CHUNK),
        load_state_dict=None, state_dict=None, min_replica_size=2, timeout=TIMEOUT,
        quorum_timeout=TIMEOUT, rank=0, world_size=1, replica_id=f"jax{gid}",
        lighthouse_addr=lighthouse, init_sync=False,
    )


def _port_manager(lighthouse: str, gid: int, wire: str) -> Manager:
    return Manager(
        collective=TCPCollective(timeout=30.0, wire_dtype=wire, chunk_bytes=CHUNK, host=HOST),
        load_state_dict=None, state_dict=None, min_replica_size=2, timeout=TIMEOUT,
        quorum_timeout=TIMEOUT, rank=0, world_size=1, replica_id=f"port{gid}",
        lighthouse_addr=lighthouse, store_addr=HOST, manager_bind=f"{HOST}:0", init_sync=False,
    )


@pytest.fixture(scope="module")
def ref():
    return {name: import_reference(f"torchft_tpu.{name}")
            for name in ("manager", "collectives", "ddp")}


def _pair(kinds: List[str], ref, wire: str, step: Callable) -> List[Any]:
    """Two groups (``kinds[g]`` "jax" or "port") on one lighthouse, each
    running ``step(kind, manager)`` once after its quorum, then the vote."""
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=2,
                                  join_timeout_ms=100)
    managers: List[Any] = [None, None]

    def group(g: int) -> Any:
        make = _jax_manager if kinds[g] == "jax" else lambda *a: _port_manager(*a)
        args = (ref, lh.address(), g, wire) if kinds[g] == "jax" else (lh.address(), g, wire)
        m = managers[g] = make(*args)
        return step(kinds[g], m, g)

    try:
        return _run_threads([lambda g=g: group(g) for g in range(2)])
    finally:
        for m in managers:
            if m is not None:
                m.shutdown()
        lh.shutdown()


def _averager_step(ref, device_wire_prep: bool):
    def step(kind: str, m, gid: int):
        m.start_quorum()
        if kind == "jax":
            import jax.numpy as jnp

            # Device prep applies to device-resident leaves only.
            leaves = [jnp.asarray(a) for a in _grads(gid)] if device_wire_prep else _grads(gid)
            avg = ref["ddp"].GradientAverager(m, bucket_bytes=BUCKET,
                                              device_wire_prep=device_wire_prep)
            out = [np.asarray(a) for a in avg.allreduce(leaves)]
        else:
            grads = [torch.from_numpy(a.copy()) for a in _grads(gid)]
            avg = GradientAverager(m, bucket_bytes=BUCKET, device_wire_prep=device_wire_prep)
            avg.allreduce(grads)
            out = [g.numpy() for g in grads]
        assert m.should_commit()
        return out, dict(avg.last_stats)
    return step


@pytest.mark.parametrize("wire, prep", [("f32", False), ("bf16", False), ("bf16", True)])
def test_averager_matches_the_jax_averager_bitwise(ref, wire, prep) -> None:
    jax_run = _pair(["jax", "jax"], ref, wire, _averager_step(ref, prep))
    port_run = _pair(["port", "port"], ref, wire, _averager_step(ref, prep))
    for g in range(2):
        (jout, jstats), (pout, pstats) = jax_run[g], port_run[g]
        assert len(jout) == len(pout)
        for i, (a, b) in enumerate(zip(jout, pout)):
            assert a.shape == b.shape and a.dtype == b.dtype, i
            assert a.tobytes() == b.tobytes(), f"group {g} gradient {i} differs bitwise"
        keys = STAT_KEYS if not prep else ("buckets", "d2h_bytes", "wire_bytes")
        assert {k: pstats[k] for k in keys} == {k: jstats[k] for k in keys}, (pstats, jstats)
    # Both groups hold the same bits (the commit protocol's premise).
    for a, b in zip(port_run[0][0], port_run[1][0]):
        assert a.tobytes() == b.tobytes()


class _StandIn:
    """A Manager stand-in: a ring of two whose allreduce hands out futures
    the test resolves (or resolves at once to ``reduce(buf)``)."""

    def __init__(self, wire: str = "f32", reduce=None) -> None:
        self.calls: List[tuple] = []
        self.futures: List[Future] = []
        self.reduce = reduce
        self.timeout = TIMEOUT
        self._col = TCPCollective(wire_dtype=wire, host=HOST)
        self._col._world_size = 2  # a ring of two, never configured

    def allreduce(self, buf, allow_wire_compression=True, donate=False):
        self.calls.append((buf.clone(), allow_wire_compression, donate))
        if self.reduce is not None:
            return completed_future(self.reduce(buf))
        fut: Future = Future()
        self.futures.append(fut)
        return fut

    def wait_quorum(self):
        pass

    def errored(self):
        return None

    def collective(self):
        return self._col

    def is_participating(self):
        return True

    def num_participants(self):
        return 2

    def size(self):
        return 2


def test_device_wire_prep_sends_the_host_cast_bits_and_halves_d2h() -> None:
    import ml_dtypes

    grads = [torch.from_numpy(a) for a in _grads(0)]
    stats, sent, plans = {}, {}, {}
    for prep in (False, True):
        m = _StandIn(wire="bf16", reduce=lambda buf: buf.clone())
        avg = GradientAverager(m, bucket_bytes=BUCKET, device_wire_prep=prep)
        avg.allreduce([g.clone() for g in grads])
        stats[prep], sent[prep] = avg.last_stats, m.calls
        plans[prep] = next(iter(avg._plans.values()))
    # The prepped buckets are bf16; the 0-d gradient rides full width, alone.
    dtypes = [buf.dtype for buf, _, _ in sent[True]]
    assert dtypes.count(torch.float32) == 1 and sent[True][-1][1] is False
    assert all(d == torch.bfloat16 for d in dtypes[:-1])
    for bucket, (buf, _, _) in zip(plans[True].buckets, sent[True]):
        if buf.dtype == torch.bfloat16:
            host = np.concatenate([grads[i].numpy().reshape(-1) for i in bucket.indices])
            want = host.astype(ml_dtypes.bfloat16).view(np.uint16)
            assert (buf.view(torch.int16).numpy().view(np.uint16) == want).all()
    scalar = 4  # the 0-d gradient's f32 bytes, full width in both modes
    assert stats[True]["d2h_bytes"] - scalar == (stats[False]["d2h_bytes"] - scalar) // 2
    # The wire carries the same bf16 bytes in both modes, but for the 0-d
    # gradient: full width (4 bytes) under prep, 2 in the host-cast bucket.
    assert stats[True]["wire_bytes"] == stats[False]["wire_bytes"] + 2
    assert stats[True]["buckets"] == stats[False]["buckets"] + 1


def test_every_bucket_is_issued_before_the_first_wait_and_failures_keep_gradients() -> None:
    m = _StandIn()
    grads = [torch.from_numpy(a) for a in _grads(1)]
    before = [g.clone() for g in grads]
    avg = GradientAverager(m, bucket_bytes=BUCKET)
    done = threading.Event()
    t = threading.Thread(target=lambda: (avg.allreduce(grads), done.set()))
    t.start()
    deadline = threading.Event()
    for _ in range(200):
        if len(m.futures) == avg.last_stats.get("buckets", -1):
            break
        deadline.wait(0.01)
    n = len(m.futures)
    assert n == avg.last_stats["buckets"] >= 3 and not done.is_set()
    assert all(donate for _, _, donate in m.calls)
    # Bucket 0 fails (resolves to its own buffer); the rest are halved.
    for k, (fut, (buf, _, _)) in enumerate(zip(m.futures, m.calls)):
        fut.set_result(avg._plans[next(iter(avg._plans))].buckets[k].host if k == 0 else buf * 0.5)
    t.join(timeout=30)
    assert done.is_set()
    plan = next(iter(avg._plans.values()))
    failed = set(plan.buckets[0].indices)
    for i, (g, b) in enumerate(zip(grads, before)):
        assert torch.equal(g, b if i in failed else b * 0.5), i


def test_mixed_jax_and_port_quorum_commits_three_steps_bitwise(ref) -> None:
    """ROADMAP 1.1.1: a JAX Manager and a port Manager in one quorum, from
    equal state: each step's Manager.allreduce and averager results are
    bitwise equal on both groups, and every vote commits."""
    def run(kind: str, m, gid: int):
        outs = []
        for s in range(3):
            m.start_quorum()
            x = (np.arange(3001, dtype=np.float32) * (gid + 1) + s) / 7
            grads = [np.asarray(a + s, dtype=np.float32) for a in _grads(gid)]
            if kind == "jax":
                y = np.asarray(m.allreduce(x).result())
                avg = ref["ddp"].GradientAverager(m, bucket_bytes=BUCKET)
                g = [np.asarray(a) for a in avg.allreduce(grads)]
            else:
                y = m.allreduce(torch.from_numpy(x)).result().numpy()
                tg = [torch.from_numpy(a) for a in grads]
                GradientAverager(m, bucket_bytes=BUCKET).allreduce(tg)
                g = [t.numpy() for t in tg]
            assert m.num_participants() == 2
            assert m.should_commit()
            outs.append([y] + g)
        assert m.current_step() == 3
        return outs

    jax_out, port_out = _pair(["jax", "port"], ref, "f32", run)
    for s in range(3):
        for a, b in zip(jax_out[s], port_out[s]):
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), f"step {s}"
    want = (np.arange(3001, dtype=np.float32) * 1 + 2) / 7 + (np.arange(3001, dtype=np.float32)
                                                             * 2 + 2) / 7
    np.testing.assert_allclose(port_out[2][0], want / 2, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("prep", [False, True])
def test_pipelined_averager_on_card_is_the_host_average(cuda_device, prep) -> None:
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=2,
                                  join_timeout_ms=100)
    wire = "bf16" if prep else "f32"
    managers: Dict[int, Manager] = {}

    def group(g: int):
        m = managers[g] = _port_manager(lh.address(), g, wire)
        grads = [torch.from_numpy(a).to(cuda_device) for a in _grads(g)]
        avg = GradientAverager(m, bucket_bytes=BUCKET, device_wire_prep=prep)
        outs = []
        for _ in range(2):  # the second step reuses the plan's buffers
            m.start_quorum()
            step = [x.clone() for x in grads]
            avg.allreduce(step)
            assert m.should_commit()
            outs.append([x.cpu().numpy() for x in step])
        return outs, dict(avg.last_stats), m.collective().ring_engine

    try:
        r0, r1 = _run_threads([lambda g=g: group(g) for g in range(2)])
    finally:
        for m in managers.values():
            m.shutdown()
        lh.shutdown()
    host = [(a + b) / np.float32(2) for a, b in zip(_grads(0), _grads(1))]
    # bf16 wire: each addend and the sum round once to bf16 (2^-9 relative).
    bf16_err = [2.0 ** -8 * (np.abs(a) + np.abs(b)) for a, b in zip(_grads(0), _grads(1))]
    for outs, stats, engine in (r0, r1):
        assert engine == "native"
        assert stats["d2h_bytes"] == stats["h2d_bytes"] > 0
        for step in outs:
            for got, want, err in zip(step, host, bf16_err):
                if prep and got.ndim:
                    assert (np.abs(got - want) <= err).all()
                else:
                    assert got.tobytes() == want.tobytes()
    for a, b in zip(r0[0][1], r1[0][1]):
        assert a.tobytes() == b.tobytes()
