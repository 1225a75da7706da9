"""The port's collective ops beyond allreduce, and its wrappers, against
the JAX package's.

- Conformance in mixed rings: at worlds 2, 3 and 4, ranks alternating
  between a JAX and a port ``TCPCollective`` (each on the Python or the
  native engine, 2 lanes) run one program of ops: allreduce by sum, avg,
  max and min (a float payload, a two-array bucket, an int64 payload),
  allgather, broadcast, reduce_scatter by sum and by max, alltoall,
  barrier and a send/recv round: every rank's results bitwise equal to an
  all-JAX Python-engine ring's, dtypes included.
- A port-only ring on torch tensors: the same program, results of the
  inputs' types (bf16 tensors over send/recv and reduce_scatter); a bf16
  send between a JAX and a port rank, each way, bit for bit.
- An invalid reduce op refused at world size 1 (allreduce and
  reduce_scatter), with the JAX package's message.
- ``DummyCollective``: every op of the JAX conformance registry.
- ``ErrorSwallowingCollective``: the latch, each op's fallback, the wire
  probes passed through, a failing inner op swallowed.
- ``ManagedCollective``: ops other than an average refused, the average
  gathered from the Manager's futures, the other ops after ``wait_quorum``.
- ``futures.context_timeout``: fires after its deadline, and not when the
  block ends first.

Inputs are drawn from seeded numpy generators.
"""

from __future__ import annotations

import itertools
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.collectives import (
    DummyCollective,
    ErrorSwallowingCollective,
    ManagedCollective,
    TCPCollective,
    Work,
)
from torchft_tpu_torch.futures import completed_future, context_timeout, failed_future

HOST = "127.0.0.1"
CHUNK = 4 << 10
_PREFIX = itertools.count()


@pytest.fixture(scope="module")
def jax_collectives():
    return import_reference("torchft_tpu.collectives")


@pytest.fixture(scope="module")
def store():
    server = _native.StoreServer(bind=f"{HOST}:0")
    yield server
    server.shutdown()


def _program(c, rank: int, n: int) -> List[np.ndarray]:
    """One program of ops, the same on every rank and in both packages."""
    rng = np.random.default_rng(500 + rank)
    x = rng.standard_normal(3001).astype(np.float32)
    out: List[Any] = []
    for op in ("sum", "avg", "max", "min"):
        out += c.allreduce([x.copy()], op=op).wait(timeout=30)
    out += c.allreduce([np.full(7, float(rank), np.float32),
                        np.full((3, 5), 2.0 * rank, np.float32)], op="sum").wait(timeout=30)
    out += c.allreduce([np.arange(100, dtype=np.int64) * (rank + 1) - 50 * rank],
                       op="max").wait(timeout=30)
    out += c.allgather(np.array([rank, rank * 10], dtype=np.int64)).wait(timeout=30)
    out.append(c.broadcast(x, root=n - 1).wait(timeout=30))
    out.append(c.reduce_scatter([x[:64] * (i + 1) for i in range(n)], op="sum").wait(timeout=30))
    out.append(c.reduce_scatter([x[:64] + i for i in range(n)], op="max").wait(timeout=30))
    out += c.alltoall([np.array([rank * 100 + d], dtype=np.int64) for d in range(n)]).wait(
        timeout=30)
    c.barrier().wait(timeout=30)
    sent = c.send(x[:16] * (rank + 1), (rank + 1) % n, tag=3)
    out.append(c.recv((16,), np.float32, (rank - 1) % n, tag=3).wait(timeout=30))
    sent.wait(timeout=30)
    return [np.asarray(o) for o in out]


def _make(kind: str, engine: str, jax_collectives):
    if kind == "jax":
        return jax_collectives.TCPCollective(timeout=30.0, chunk_bytes=CHUNK, lanes=2,
                                             topology="ring", engine=engine, transport="tcp")
    return TCPCollective(timeout=30.0, chunk_bytes=CHUNK, lanes=2, engine=engine, host=HOST,
                         topology="ring", transport="tcp")


def _run(store, cols) -> Dict[int, List[np.ndarray]]:
    prefix = f"ops/{next(_PREFIX)}"
    n = len(cols)

    def worker(rank: int) -> List[np.ndarray]:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, n)
        return _program(c, rank, n)

    try:
        with ThreadPoolExecutor(max_workers=n) as pool:
            futs = [pool.submit(worker, r) for r in range(n)]
            return {r: f.result(timeout=120) for r, f in enumerate(futs)}
    finally:
        for c in cols:
            c.shutdown()


_REFERENCE: Dict[int, Dict[int, List[np.ndarray]]] = {}


def _all_jax(store, n: int, jax_collectives) -> Dict[int, List[np.ndarray]]:
    if n not in _REFERENCE:
        _REFERENCE[n] = _run(store, [_make("jax", "py", jax_collectives) for _ in range(n)])
    return _REFERENCE[n]


def _assert_bitwise(a: List[np.ndarray], b: List[np.ndarray], ctx: str) -> None:
    assert len(a) == len(b), ctx
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, (ctx, i, x.dtype, y.dtype)
        assert x.tobytes() == y.tobytes(), (ctx, i)


@pytest.mark.parametrize("jax_engine, port_engine",
                         [("py", "py"), ("native", "native"), ("py", "native")])
@pytest.mark.parametrize("world", [2, 3, 4])
def test_mixed_ring_every_op_bitwise_equals_an_all_jax_ring(store, jax_collectives, world,
                                                            jax_engine, port_engine) -> None:
    ref = _all_jax(store, world, jax_collectives)
    cols = [_make("jax", jax_engine, jax_collectives) if r % 2 == 0
            else _make("port", port_engine, jax_collectives) for r in range(world)]
    got = _run(store, cols)
    for rank in range(world):
        _assert_bitwise(ref[rank], got[rank], f"world {world} rank {rank}")
    # The values, once: max and min are exact, the object ops move bits.
    xs = [np.random.default_rng(500 + r).standard_normal(3001).astype(np.float32)
          for r in range(world)]
    np.testing.assert_array_equal(got[0][2], np.max(xs, axis=0))
    np.testing.assert_array_equal(got[0][3], np.min(xs, axis=0))
    for rank in range(world):
        out = got[rank]
        np.testing.assert_array_equal(out[4], np.full(7, sum(range(world)), np.float32))
        ag = out[7:7 + world]
        assert [a.tolist() for a in ag] == [[r, 10 * r] for r in range(world)]
        np.testing.assert_array_equal(out[7 + world], xs[-1])
        a2a = out[10 + world:10 + 2 * world]
        assert [int(a[0]) for a in a2a] == [src * 100 + rank for src in range(world)]
        np.testing.assert_array_equal(out[-1], xs[(rank - 1) % world][:16]
                                      * np.float32((rank - 1) % world + 1))


@pytest.mark.parametrize("engine", ["py", "native"])
@pytest.mark.parametrize("world", [2, 3])
def test_port_ring_ops_on_tensors_keep_the_callers_types(store, world, engine) -> None:
    cols = [TCPCollective(timeout=30.0, chunk_bytes=CHUNK, lanes=2, engine=engine, host=HOST)
            for _ in range(world)]
    prefix = f"ops/t/{next(_PREFIX)}"

    def worker(rank: int) -> dict:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, world)
        x = torch.arange(12, dtype=torch.float32) * (rank + 1)
        out = {
            "max": c.allreduce([x], op="max").wait(timeout=30)[0],
            "ag": c.allgather(x[:3]).wait(timeout=30),
            "bc": c.broadcast(x, root=0).wait(timeout=30),
            "rs": c.reduce_scatter([x + i for i in range(world)], op="min").wait(timeout=30),
            "rs_bf16": c.reduce_scatter([torch.full((4,), 0.5 * (i + 1), dtype=torch.bfloat16)
                                         for i in range(world)]).wait(timeout=30),
            "a2a": c.alltoall([torch.tensor([rank * 10 + d]) for d in range(world)]).wait(
                timeout=30),
        }
        sent = c.send(torch.full((5,), rank + 1.5, dtype=torch.bfloat16), (rank + 1) % world,
                      tag=2)
        out["bf16"] = c.recv((5,), torch.bfloat16, (rank - 1) % world, tag=2).wait(timeout=30)
        sent.wait(timeout=30)
        sent = c.send(np.full(3, rank, np.int16), (rank + 1) % world, tag=4)
        out["np"] = c.recv((3,), np.int16, (rank - 1) % world, tag=4).wait(timeout=30)
        sent.wait(timeout=30)
        c.barrier().wait(timeout=30)
        c.shutdown()
        return out

    with ThreadPoolExecutor(max_workers=world) as pool:
        res = [f.result(timeout=120) for f in [pool.submit(worker, r) for r in range(world)]]
    for rank, out in enumerate(res):
        assert torch.equal(out["max"], torch.arange(12, dtype=torch.float32) * world)
        assert all(isinstance(a, torch.Tensor) for a in out["ag"])
        assert [a.tolist() for a in out["ag"]] == [[0.0, r + 1.0, 2.0 * (r + 1)]
                                                   for r in range(world)]
        assert torch.equal(out["bc"], torch.arange(12, dtype=torch.float32))
        assert torch.equal(out["rs"], torch.arange(12, dtype=torch.float32) + rank)
        assert out["rs_bf16"].dtype == torch.bfloat16
        assert out["rs_bf16"].tolist() == [0.5 * (rank + 1) * world] * 4
        assert [int(a[0]) for a in out["a2a"]] == [src * 10 + rank for src in range(world)]
        assert out["bf16"].dtype == torch.bfloat16
        assert out["bf16"].tolist() == [(rank - 1) % world + 1.5] * 5
        assert isinstance(out["np"], np.ndarray) and out["np"].dtype == np.int16
        assert out["np"].tolist() == [(rank - 1) % world] * 3


def test_bf16_send_recv_between_a_jax_and_a_port_rank(store, jax_collectives) -> None:
    """A JAX rank's ml_dtypes bfloat16 array arrives at a port rank as a bf16
    tensor, and a port rank's bf16 tensor at a JAX rank as a bfloat16
    array, bit for bit; the pickled ops refuse bf16 tensors."""
    import ml_dtypes

    bf16 = np.dtype(ml_dtypes.bfloat16)
    vals = np.random.default_rng(61).standard_normal(8).astype(np.float32)
    cols = [_make("jax", "native", jax_collectives), _make("port", "native", jax_collectives)]
    prefix = f"ops/bf16/{next(_PREFIX)}"

    def worker(rank: int):
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, 2)
        if rank == 0:
            sent = c.send(vals.astype(bf16), 1, tag=5)
            got = c.recv((8,), bf16, 1, tag=6).wait(timeout=30)
        else:
            sent = c.send(torch.from_numpy(vals).to(torch.bfloat16) * 2, 0, tag=6)
            got = c.recv((8,), torch.bfloat16, 0, tag=5).wait(timeout=30)
        sent.wait(timeout=30)
        return got

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            futs = [pool.submit(worker, r) for r in range(2)]
            at_jax, at_port = (f.result(timeout=60) for f in futs)
    finally:
        for c in cols:
            c.shutdown()
    assert at_jax.dtype == bf16 and at_port.dtype == torch.bfloat16
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert at_port.view(torch.int16).tolist() == want.view(torch.int16).tolist()
    assert at_jax.view(np.uint16).tolist() == (want * 2).view(torch.int16).numpy().view(
        np.uint16).tolist()
    port = TCPCollective(timeout=5.0, host=HOST)
    with pytest.raises(ValueError, match="bf16"):
        port.allgather(torch.zeros(2, dtype=torch.bfloat16)).wait(timeout=5)


def test_invalid_reduce_op_fails_even_at_world_size_one(store, jax_collectives) -> None:
    port = TCPCollective(timeout=5.0, host=HOST)
    ref = jax_collectives.TCPCollective(timeout=5.0)
    for c in (port, ref):
        c.configure(f"{store.address()}/ops/one/{next(_PREFIX)}", 0, 1)
    messages = []
    try:
        for c in (port, ref):
            for call in (lambda: c.allreduce([np.ones(4, np.float32)], op="prod"),
                         lambda: c.reduce_scatter([np.ones(4, np.float32)], op="mx")):
                with pytest.raises(ValueError, match="unsupported reduce op") as info:
                    call().wait(timeout=5)
                messages.append(str(info.value))
    finally:
        port.shutdown()
        ref.shutdown()
    assert messages[:2] == messages[2:]
    # Every valid op resolves at world size 1, as the inputs.
    one = TCPCollective(timeout=5.0, host=HOST)
    one.configure(f"{store.address()}/ops/one/{next(_PREFIX)}", 0, 1)
    try:
        for op in ("sum", "avg", "max", "min"):
            out = one.allreduce([np.arange(3, dtype=np.float32)], op=op).wait(timeout=5)[0]
            np.testing.assert_array_equal(out, np.arange(3, dtype=np.float32))
    finally:
        one.shutdown()


# -- DummyCollective: the JAX conformance registry at world size 1 -------------


def _dummy_checks() -> Dict[str, Any]:
    def allreduce(c):
        for op in ("sum", "avg", "max", "min"):
            out = c.allreduce([np.full(16, 2.0, np.float32)], op=op).wait(timeout=5)[0]
            np.testing.assert_array_equal(out, np.full(16, 2.0, np.float32))

    def multi(c):
        out = c.allreduce([np.full(7, 1.0, np.float32), torch.full((3, 5), 2.0)]).wait(timeout=5)
        np.testing.assert_array_equal(out[0], np.full(7, 1.0, np.float32))
        assert torch.equal(out[1], torch.full((3, 5), 2.0))

    def allgather(c):
        out = c.allgather(np.array([0, 0], np.int64)).wait(timeout=5)
        assert len(out) == 1 and out[0].tolist() == [0, 0]

    def broadcast(c):
        np.testing.assert_array_equal(c.broadcast(np.full(8, 5.0)).wait(timeout=5),
                                      np.full(8, 5.0))

    def reduce_scatter(c):
        np.testing.assert_array_equal(c.reduce_scatter([np.full(4, 3.0)]).wait(timeout=5),
                                      np.full(4, 3.0))

    def alltoall(c):
        assert [a.tolist() for a in c.alltoall([np.array([7])]).wait(timeout=5)] == [[7]]

    def barrier(c):
        assert c.barrier().wait(timeout=5) is None

    def send_recv(c):
        assert c.send(np.ones(2), 0).wait(timeout=5) is None
        assert c.recv((2,), np.int32, 0).wait(timeout=5).tolist() == [0, 0]
        got = c.recv((2,), torch.bfloat16, 0).wait(timeout=5)
        assert got.dtype == torch.bfloat16 and got.tolist() == [0.0, 0.0]

    return {"allreduce": allreduce, "allreduce_multi": multi, "allgather": allgather,
            "broadcast": broadcast, "reduce_scatter": reduce_scatter, "alltoall": alltoall,
            "barrier": barrier, "send_recv": send_recv}


@pytest.mark.parametrize("op", sorted(_dummy_checks()))
def test_dummy_collective_conformance(op) -> None:
    c = DummyCollective()
    c.configure("unused", 0, 1)
    assert c.configure_count == 1 and c.size() == 1 and c.rank() == 0
    _dummy_checks()[op](c)


# -- the wrappers ----------------------------------------------------------------


def test_error_swallowing_wrapper_latches_and_falls_back(jax_collectives) -> None:
    inner = DummyCollective()
    wrapper = ErrorSwallowingCollective(inner)
    ref = jax_collectives.ErrorSwallowingCollective(jax_collectives.DummyCollective())
    for w in (wrapper, ref):
        w.configure("unused", 0, 1)
        assert w.errored() is None
        w.report_error(RuntimeError("boom"))
        assert w.errored() is not None
    x = np.full(3, 7.0, dtype=np.float32)
    np.testing.assert_array_equal(wrapper.allreduce([x]).wait(timeout=5)[0], x)
    assert wrapper.allgather(x).wait(timeout=5)[0] is x
    assert wrapper.broadcast(x).wait(timeout=5) is x
    assert wrapper.reduce_scatter([x]).wait(timeout=5) is x
    assert wrapper.alltoall([x]).wait(timeout=5) == [x]
    assert wrapper.send(x, 0).wait(timeout=5) is None
    assert wrapper.recv((2,), np.float32, 0).wait(timeout=5).tolist() == [0.0, 0.0]
    assert wrapper.recv((2,), torch.int32, 0).wait(timeout=5).tolist() == [0, 0]
    assert wrapper.barrier().wait(timeout=5) is None
    # configure clears the latch, in both packages.
    for w in (wrapper, ref):
        w.configure("unused", 0, 1)
        assert w.errored() is None


def test_error_swallowing_wrapper_swallows_a_failing_op_and_proxies_the_wire(
        jax_collectives) -> None:
    inner = TCPCollective(timeout=5.0, wire_dtype="bf16", host=HOST)
    wrapper = ErrorSwallowingCollective(inner)
    ref = jax_collectives.ErrorSwallowingCollective(
        jax_collectives.TCPCollective(timeout=5.0, wire_dtype="bf16"))
    assert wrapper.wire_dtype == ref.wire_dtype == "bf16"
    assert tuple(wrapper.wire_codecs) == tuple(ref.wire_codecs)
    x = np.ones(1001, dtype=np.float32)
    for codec in (None, "int8", "int4"):
        assert wrapper.wire_nbytes(x, True, codec) == ref.wire_nbytes(x, True, codec)
    assert wrapper.wire_nbytes(x, False) == ref.wire_nbytes(x, False)
    # An inner op that fails: the wrapper resolves to the inputs, latches,
    # and the next op never reaches the inner collective.
    calls = []

    class Failing(DummyCollective):
        def allreduce(self, arrays, op="sum", allow_wire_compression=True, donate=False,
                      wire_codec=None):
            calls.append(op)
            return Work(failed_future(ConnectionError("peer connection closed")))

    wrapper = ErrorSwallowingCollective(Failing())
    out = wrapper.allreduce([x]).wait(timeout=5)
    assert out[0] is x
    assert isinstance(wrapper.errored(), ConnectionError)
    assert wrapper.allreduce([x], op="max").wait(timeout=5)[0] is x
    assert calls == ["sum"]


def test_managed_collective_rejects_non_average_ops() -> None:
    manager = MagicMock()
    mc = ManagedCollective(manager)
    for op in ("max", "min", "prod"):
        with pytest.raises(ValueError, match="not expressible"):
            mc.allreduce([np.ones(4, dtype=np.float32)], op=op).wait(timeout=5)
    manager.allreduce.assert_not_called()


def test_managed_collective_averages_through_the_manager_and_waits_for_quorum() -> None:
    manager = MagicMock()
    inner = DummyCollective()
    manager.collective.return_value = inner
    pending: List[Future] = []

    def allreduce(a):
        f: Future = Future()
        pending.append((f, a))
        return f

    manager.allreduce.side_effect = allreduce
    manager.num_participants.return_value = 3
    manager.participating_rank.return_value = None
    manager.errored.return_value = None
    mc = ManagedCollective(manager)
    work = mc.allreduce([np.ones(2), np.zeros(3)], op="avg")
    assert not work.done()
    for f, a in pending:
        f.set_result(a * 2)
    got = work.wait(timeout=5)
    assert [g.tolist() for g in got] == [[2.0, 2.0], [0.0, 0.0, 0.0]]
    assert mc.size() == 3 and mc.rank() == 0 and mc.errored() is None
    assert mc.allgather(np.ones(1)).wait(timeout=5)[0].tolist() == [1.0]
    assert mc.barrier().wait(timeout=5) is None
    assert manager.wait_quorum.call_count == 2
    mc.configure("unused", 0, 1)
    assert inner.configure_count == 1


# -- futures.context_timeout -------------------------------------------------------


@pytest.mark.parametrize("package", ["port", "jax"])
def test_context_timeout_fires_callback(package) -> None:
    ctx = (context_timeout if package == "port"
           else import_reference("torchft_tpu.futures").context_timeout)
    fired = []
    with ctx(lambda: fired.append(True), 0.05):
        time.sleep(0.3)
    assert fired


@pytest.mark.parametrize("package", ["port", "jax"])
def test_context_timeout_cancelled_on_fast_exit(package) -> None:
    ctx = (context_timeout if package == "port"
           else import_reference("torchft_tpu.futures").context_timeout)
    fired = []
    with ctx(lambda: fired.append(True), 5.0):
        pass
    time.sleep(0.1)
    assert not fired
    assert completed_future(1).result() == 1
