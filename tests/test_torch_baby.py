"""The port's crash-isolated collective against the JAX package's.

- Twins of ``tests/test_baby.py``: every op through the child process
  (numpy arrays and CPU tensors, bf16 included), op streams that stay
  concurrent across the process boundary, a child SIGKILLed mid-run
  latched on both ranks and recovered by the next ``configure``, a storm of
  kill-and-reconfigure generations, ``abort`` killing the child, the
  monitored pipe re-raising, and the device wait's timeout.
- A CUDA tensor is refused before it reaches the pipe.
- A Baby port rank and JAX ``TCPCollective`` ranks in one ring: every op's
  results bitwise an all-JAX ring's.
- The JAX package's ``BabyCollective`` under JAX Managers with
  ``donate=True`` (what the JAX averager passes) reports ``TypeError`` and
  never commits; the port's commits, bitwise the plain ring's average.
- A communicator crash under two port Managers on a real lighthouse: the
  Baby group heals over send/recv through its child, runs merged steps,
  then its child is SIGKILLed during an allreduce: the op fails within the
  timeout naming the child's exit, ``errored()`` latches, the vote fails on
  both groups and keeps failing (the membership, and so the quorum id, is
  unchanged: nothing reconfigures) until the Baby group raises
  ``ExceededMaxRetriesError``; restarted, it heals and both groups end
  with one state.

Inputs come from seeded numpy generators.
"""

from __future__ import annotations

import itertools
import multiprocessing
import os
import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import timedelta
from typing import Any, Callable, Dict, List

import numpy as np
import pytest
import torch

from test_torch_collective_ops import _assert_bitwise, _program
from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.baby import BabyCollective, BabyTCPCollective, MonitoredPipe
from torchft_tpu_torch.checkpointing import CollectiveTransport
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.futures import event_wait
from torchft_tpu_torch.manager import ExceededMaxRetriesError, Manager

HOST = "127.0.0.1"
T = 30.0
_PREFIX = itertools.count()


@pytest.fixture(scope="module")
def store():
    server = _native.StoreServer(bind=f"{HOST}:0")
    yield server
    server.shutdown()


def _prefix() -> str:
    return f"baby/{next(_PREFIX)}"


def _babies(n: int, timeout: float = T) -> List[BabyCollective]:
    return [BabyTCPCollective(timeout=timeout, host=HOST) for _ in range(n)]


def _run_ranks(store, cols: List[Any], fn: Callable[[Any, int], Any],
               shutdown: bool = True) -> List[Any]:
    prefix = _prefix()
    n = len(cols)

    def worker(rank: int) -> Any:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, n)
        try:
            return fn(c, rank)
        finally:
            if shutdown:
                c.shutdown()

    with ThreadPoolExecutor(max_workers=n) as pool:
        futures = [pool.submit(worker, r) for r in range(n)]
        return [f.result(timeout=120) for f in futures]


# -- the ops through the child ------------------------------------------------------------


def _checks() -> Dict[str, Callable[[Any, int], bool]]:
    def allreduce(c, rank):
        n = c.size()
        x = np.arange(8, dtype=np.float32) * (1 if rank % 2 == 0 else -1) + rank
        every = np.stack([np.arange(8, dtype=np.float32) * (1 if r % 2 == 0 else -1) + r
                          for r in range(n)])
        for op, want in (("sum", every.sum(0)), ("avg", every.sum(0) / n),
                         ("max", every.max(0)), ("min", every.min(0))):
            np.testing.assert_array_equal(c.allreduce([x.copy()], op=op).wait(timeout=T)[0],
                                          want.astype(np.float32))
        return True

    def allreduce_multi(c, rank):
        out = c.allreduce([np.full(7, float(rank), np.float32),
                           torch.full((3, 5), 2.0 * rank)]).wait(timeout=T)
        total = sum(range(c.size()))
        np.testing.assert_array_equal(out[0], np.full(7, total, np.float32))
        assert isinstance(out[1], torch.Tensor)
        assert torch.equal(out[1], torch.full((3, 5), 2.0 * total))
        return True

    def allreduce_bf16(c, rank):
        out = c.allreduce([torch.full((16,), float(rank + 1), dtype=torch.bfloat16)]).wait(
            timeout=T)[0]
        assert out.dtype == torch.bfloat16
        assert torch.equal(out.float(), torch.full((16,), float(sum(range(1, c.size() + 1)))))
        return True

    def allgather(c, rank):
        out = c.allgather(np.array([rank, rank * 10], dtype=np.int64)).wait(timeout=T)
        assert [o.tolist() for o in out] == [[r, 10 * r] for r in range(c.size())]
        return True

    def broadcast(c, rank):
        out = c.broadcast(torch.full((8,), float(rank + 5)), root=0).wait(timeout=T)
        assert torch.equal(out, torch.full((8,), 5.0))
        return True

    def reduce_scatter(c, rank):
        n = c.size()
        out = c.reduce_scatter([np.full(4, float(rank + i), np.float32) for i in range(n)],
                               op="sum").wait(timeout=T)
        np.testing.assert_array_equal(out, np.full(4, sum(r + rank for r in range(n)),
                                                   np.float32))
        return True

    def alltoall(c, rank):
        out = c.alltoall([np.array([rank * 100 + d], np.int64) for d in range(c.size())]).wait(
            timeout=T)
        assert [int(o[0]) for o in out] == [src * 100 + rank for src in range(c.size())]
        return True

    def barrier(c, rank):
        assert c.barrier().wait(timeout=T) is None
        return True

    def send_recv(c, rank):
        n = c.size()
        nxt, prv = (rank + 1) % n, (rank - 1) % n
        sent = c.send(np.array([rank, 42], np.int32), nxt, tag=1)
        got = c.recv((2,), np.int32, prv, tag=1).wait(timeout=T)
        sent.wait(timeout=T)
        assert got.tolist() == [prv, 42]
        sent = c.send(torch.full((8,), float(rank + 1), dtype=torch.bfloat16), nxt, tag=6)
        got = c.recv((8,), torch.bfloat16, prv, tag=6).wait(timeout=T)
        sent.wait(timeout=T)
        assert got.dtype == torch.bfloat16 and torch.equal(got.float(),
                                                           torch.full((8,), float(prv + 1)))
        return True

    return {f.__name__: f for f in (allreduce, allreduce_multi, allreduce_bf16, allgather,
                                    broadcast, reduce_scatter, alltoall, barrier, send_recv)}


@pytest.mark.parametrize("op", sorted(_checks()))
def test_baby_collective_conformance(store, op) -> None:
    assert all(_run_ranks(store, _babies(2), _checks()[op]))


def test_a_cuda_tensor_is_refused_before_the_pipe() -> None:
    baby = BabyTCPCollective(timeout=5.0)
    for work in (baby.allreduce([torch.ones(2, device="meta")]),
                 baby.send(torch.ones(2, device="meta"), 0)):
        with pytest.raises(ValueError, match="host buffers"):
            work.wait(timeout=5)
    assert baby.child_pid() is None  # nothing was spawned
    baby.shutdown()


def test_baby_concurrent_op_streams(store) -> None:
    """Each rank submits a blocking recv before the matching send (and an
    allreduce between): a child that ran ops to completion in submission
    order would wedge here."""
    def worker(c, rank):
        peer = 1 - rank
        r = c.recv((1024,), np.float32, src=peer, tag=10 + peer)
        a = c.allreduce([np.full(16, float(rank + 1), dtype=np.float32)], op="sum")
        s = c.send(np.full(1024, float(rank + 1), dtype=np.float32), dst=peer, tag=10 + rank)
        np.testing.assert_array_equal(r.wait(timeout=25), np.full(1024, float(peer + 1)))
        np.testing.assert_array_equal(a.wait(timeout=25)[0], np.full(16, 3.0))
        s.wait(timeout=25)
        return True

    assert all(_run_ranks(store, _babies(2), worker))


def _one_generation(store, babies: List[BabyCollective]) -> None:
    def worker(c, rank):
        out = c.allreduce([np.full(8, float(rank + 1), dtype=np.float32)]).wait(timeout=60)
        np.testing.assert_array_equal(out[0], np.full(8, 3.0))

    _run_ranks(store, babies, worker, shutdown=False)


def _kill_child(baby: BabyCollective) -> None:
    """SIGKILLs the child and waits for it, polling under the baby's
    ``_proc_lock`` as the baby's own threads do: a second concurrent poll
    of a forkserver child would record exit code 255."""
    proc = baby._proc
    assert proc is not None
    proc.kill()
    with baby._proc_lock:
        proc.join(timeout=30)
        assert not proc.is_alive()


def test_baby_child_crash_latches_and_recovers(store) -> None:
    babies = _babies(2, timeout=60.0)
    try:
        _one_generation(store, babies)
        pid = babies[1].child_pid()
        _kill_child(babies[1])
        with pytest.raises(Exception):
            babies[0].allreduce([np.ones(64, dtype=np.float32)]).wait(timeout=90)
        assert babies[0].errored() is not None
        err = babies[1].errored()
        assert isinstance(err, RuntimeError)
        assert str(err) == "collective subprocess died (exit code -9)"
        with pytest.raises(RuntimeError, match="subprocess died"):
            babies[1].allreduce([np.ones(4, np.float32)]).wait(timeout=5)
        # The next quorum's configure spawns a fresh child.
        _one_generation(store, babies)
        assert babies[1].child_pid() != pid and babies[1].errored() is None
    finally:
        for c in babies:
            c.shutdown()


def test_baby_reconfigure_storm(store) -> None:
    babies = _babies(2, timeout=60.0)
    try:
        for gen in range(6):
            _one_generation(store, babies)
            victim = gen % 2
            _kill_child(babies[victim])
            with pytest.raises(Exception):
                babies[1 - victim].allreduce([np.ones(8, dtype=np.float32)]).wait(timeout=90)
            assert babies[1 - victim].errored() is not None
            assert babies[victim].errored() is not None
    finally:
        for c in babies:
            c.shutdown()


def test_baby_abort_kills_child(store) -> None:
    babies = _babies(2)
    _run_ranks(store, babies, lambda c, r: None, shutdown=False)
    proc = babies[0]._proc
    babies[0].abort()
    assert babies[0].errored() is not None
    with babies[0]._proc_lock:
        proc.join(timeout=5)
        assert not proc.is_alive()
    assert babies[0].allreduce([np.ones(4, np.float32)]).exception(timeout=5) is not None
    for c in babies:
        c.shutdown()


def test_concurrent_polls_of_a_dead_child_all_read_its_exit_code(monkeypatch) -> None:
    """A forkserver child's exit code is read once from the server's pipe:
    polls from several threads at once (the reader, the train thread's
    next op, the vote's ``errored()``) must not let a second read find the
    pipe empty and record 255.  The window between a poll's check and its
    read is widened here."""
    import multiprocessing.connection

    from torchft_tpu_torch.baby import _mp_context

    baby = BabyTCPCollective(timeout=30.0)
    proc = _mp_context().Process(target=time.sleep, args=(60,), daemon=True)
    proc.start()
    baby._proc = proc
    os.kill(proc.pid, signal.SIGKILL)
    time.sleep(0.5)  # the server has the exit status
    real_wait = multiprocessing.connection.wait

    def slow_wait(*args: Any, **kwargs: Any) -> Any:
        out = real_wait(*args, **kwargs)
        time.sleep(0.05)
        return out

    monkeypatch.setattr(multiprocessing.connection, "wait", slow_wait)
    seen: List[str] = []
    threads = [threading.Thread(target=lambda: seen.append(str(baby._died(proc))))
               for _ in range(4)]
    threads.append(threading.Thread(target=lambda: seen.append(str(baby.errored()))))
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert seen == ["collective subprocess died (exit code -9)"] * 5, seen
    baby._proc = None


def test_monitored_pipe_reraises_exceptions() -> None:
    a, b = multiprocessing.Pipe()
    left, right = MonitoredPipe(a), MonitoredPipe(b)
    left.send(ValueError("boom"))
    with pytest.raises(ValueError, match="boom"):
        right.recv(timeout=5)
    left.send({"ok": 1})
    assert right.recv(timeout=5) == {"ok": 1}
    with pytest.raises(TimeoutError):
        right.recv(timeout=0.05)
    left.close()
    right.close()
    assert left.closed() and right.closed()


def test_large_arrays_cross_the_pipe_raw() -> None:
    """Arrays of a MiB or more travel as raw bytes after their message, in
    walk order, bf16 tensors and exceptions beside them."""
    a, b = multiprocessing.Pipe()
    left, right = MonitoredPipe(a), MonitoredPipe(b)
    rng = np.random.default_rng(2300)
    big = rng.standard_normal(700_000).astype(np.float32)  # 2.8 MB
    bf16 = torch.from_numpy(rng.standard_normal(600_000).astype(np.float32)).to(torch.bfloat16)
    from torchft_tpu_torch.baby import _from_pipe, _to_pipe

    sent = ("op", 3, [big, np.arange(5), big[::2]], _to_pipe([bf16]))
    t = threading.Thread(target=left.send, args=(sent,))
    t.start()
    got = right.recv(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    assert got[:2] == ("op", 3)
    assert got[2][0].tobytes() == big.tobytes() and got[2][1].tolist() == list(range(5))
    assert got[2][2].tobytes() == big[::2].tobytes()
    out = _from_pipe(got[3])[0]
    assert out.dtype == torch.bfloat16 and torch.equal(out, bf16)
    left.send(RuntimeError("after the bulk"))
    with pytest.raises(RuntimeError, match="after the bulk"):
        right.recv(timeout=5)
    left.close()
    right.close()


def test_a_large_allreduce_through_the_child_is_bitwise_the_plain_rings(store) -> None:
    """A 6 MB float32 and a 2 MB bf16 payload (the bulk path both ways)
    through baby ranks equal a plain port ring's results, bit for bit."""
    def payload(rank: int):
        rng = np.random.default_rng(2400 + rank)
        return (rng.standard_normal(1_500_000).astype(np.float32),
                torch.from_numpy(rng.standard_normal(1 << 20).astype(np.float32)).to(
                    torch.bfloat16))

    def body(c, rank):
        x, y = payload(rank)
        return (c.allreduce([x]).wait(timeout=60)[0],
                c.allreduce([y]).wait(timeout=60)[0].view(torch.int16).numpy())

    got = _run_ranks(store, _babies(2, timeout=60.0), body)
    ref = _run_ranks(store, [TCPCollective(timeout=60.0, host=HOST) for _ in range(2)], body)
    for g, r in zip(got, ref):
        assert g[0].tobytes() == r[0].tobytes() and g[1].tobytes() == r[1].tobytes()


def test_device_wait_timeout() -> None:
    """The port's wait for device work (``device_get``'s event wait): a
    wedged event surfaces as TimeoutError within the deadline, and a later
    wait still works."""
    gate = threading.Event()

    class _Wedge:
        def query(self) -> bool:
            return gate.is_set()

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="device copy did not complete"):
        event_wait(_Wedge(), timeout=0.2, what="device copy")
    assert time.monotonic() - t0 < 5
    gate.set()
    event_wait(_Wedge(), timeout=5)


# -- against the JAX package ---------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_collectives():
    return import_reference("torchft_tpu.collectives")


@pytest.mark.parametrize("world", [2, 3])
def test_a_baby_rank_in_a_jax_ring_is_bitwise_an_all_jax_ring(store, jax_collectives,
                                                              world) -> None:
    def jax_rank():
        return jax_collectives.TCPCollective(timeout=T, chunk_bytes=4 << 10, lanes=2,
                                             topology="ring", engine="py", transport="tcp")

    def run(cols):
        return _run_ranks(store, cols, lambda c, r: _program(c, r, world))

    ref = run([jax_rank() for _ in range(world)])
    got = run([BabyTCPCollective(timeout=T, chunk_bytes=4 << 10, lanes=2, host=HOST,
                                 topology="ring", transport="tcp") if r == 1 else jax_rank()
               for r in range(world)])
    for rank in range(world):
        _assert_bitwise(ref[rank], got[rank], f"world {world} rank {rank}")


def _donating_groups(lighthouse: str, make_manager: Callable[[int], Any], steps: int
                     ) -> Dict[int, List[tuple]]:
    """Two groups in threads; each step allreduces with ``donate=True`` and
    votes.  Returns each group's (committed, error, averaged) a step."""
    out: Dict[int, List[tuple]] = {0: [], 1: []}
    errors: List[BaseException] = []

    def run(gid: int) -> None:
        m = make_manager(gid)
        try:
            for step in range(steps):
                m.start_quorum()
                x = np.full(6, float(gid + 1) * (step + 1), dtype=np.float32)
                avg = m.allreduce(x, donate=True).result()
                committed = m.should_commit()
                out[gid].append((committed, repr(m.errored()), np.asarray(avg).tolist()))
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)
        finally:
            m.shutdown()

    threads = [threading.Thread(target=run, args=(g,)) for g in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a group hung"
    if errors:
        raise errors[0]
    return out


def test_jax_baby_rejects_donate_under_a_manager_while_the_port_commits() -> None:
    jax_manager = import_reference("torchft_tpu.manager")
    jax_baby = import_reference("torchft_tpu.baby")
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=2, join_timeout_ms=200)
    timeout = timedelta(seconds=T)
    try:
        def jax_group(gid: int):
            return jax_manager.Manager(
                collective=jax_baby.BabyTCPCollective(timeout=T), load_state_dict=lambda sd: None,
                state_dict=lambda: {}, min_replica_size=2, rank=0, world_size=1,
                replica_id=f"jaxbaby{gid}", lighthouse_addr=lh.address(), store_addr=HOST,
                manager_bind=f"{HOST}:0", timeout=timeout, quorum_timeout=timeout,
                init_sync=False)

        def port_group(gid: int):
            return Manager(
                collective=BabyTCPCollective(timeout=T, host=HOST),
                load_state_dict=lambda sd: None, state_dict=lambda: {}, min_replica_size=2,
                rank=0, world_size=1, replica_id=f"portbaby{gid}", lighthouse_addr=lh.address(),
                store_addr=HOST, manager_bind=f"{HOST}:0", timeout=timeout,
                quorum_timeout=timeout, init_sync=False)

        jax_run = _donating_groups(lh.address(), jax_group, steps=2)
        port_run = _donating_groups(lh.address(), port_group, steps=2)
    finally:
        lh.shutdown()
    for gid in (0, 1):
        assert [c for c, _, _ in jax_run[gid]] == [False, False]
        assert all("TypeError" in e and "donate" in e for _, e, _ in jax_run[gid])
        assert [c for c, _, _ in port_run[gid]] == [True, True]
        assert [a for _, _, a in port_run[gid]] == [[1.5 * (s + 1)] * 6 for s in range(2)]


# -- a communicator crash under two Managers ----------------------------------------------


MERGED = 3


def _ft_group(gid: int, inc: int, lighthouse: str, shared: dict, baby: bool) -> None:
    """One group: a tensor trained by the average of per-group gradients.
    A Baby group (``max_retries=2``) kills its child during an allreduce
    once it has MERGED merged commits, when ``shared["kill"]`` is set.  It
    arms the kill before that step's quorum, and the other group, once the
    quorum has formed, holds its allreduce until the child is killed: the
    child cannot finish the exchange first (it would, under load, and the
    other group would commit the step the Baby fails)."""
    params = {"w": torch.zeros(300)}

    def load(sd: Dict[str, torch.Tensor]) -> None:
        params["w"].copy_(sd["w"])

    collective = (BabyTCPCollective(timeout=T, host=HOST) if baby
                  else TCPCollective(timeout=T, host=HOST))
    configures: List[int] = []
    configure = collective.configure

    def counted(*args: Any) -> None:
        configure(*args)
        configures.append(collective.child_pid() if baby else 0)

    collective.configure = counted
    m = Manager(
        collective=collective, load_state_dict=load, state_dict=lambda: params,
        min_replica_size=1, rank=0, world_size=1, replica_id=f"baby_g{gid}",
        lighthouse_addr=lighthouse, store_addr=HOST, manager_bind=f"{HOST}:0",
        checkpoint_transport=CollectiveTransport(collective, timeout=T,
                                                 state_dict_fn=lambda: params),
        timeout=timedelta(seconds=T), quorum_timeout=timedelta(seconds=60), init_sync=False,
        max_retries=2 if baby else None,
    )
    log: List[dict] = []
    shared["logs"][(gid, inc)] = log
    merged = 0
    try:
        for _ in range(400):
            target = shared["target"]
            if target is not None and m.current_step() >= target:
                break
            killing = baby and shared["kill"] and merged >= MERGED and not shared["killed"]
            if killing:
                shared["armed"] = True
            m.start_quorum()
            step = m.current_step()
            if not baby and shared["kill"] and not shared["killed"]:
                # Once this step's quorum has formed, the Baby has made its
                # request, and so armed the kill if this is its step.
                m.wait_quorum()
                deadline = time.monotonic() + 60
                while shared["armed"] and not shared["killed"]:
                    assert time.monotonic() < deadline, "the armed Baby never killed its child"
                    time.sleep(0.005)
            if killing:
                allreduce = collective.allreduce

                def and_kill(*args: Any, **kwargs: Any) -> Any:
                    work = allreduce(*args, **kwargs)
                    pid, t_kill = collective.child_pid(), time.monotonic()
                    os.kill(pid, signal.SIGKILL)
                    shared["killed"].append((pid, t_kill))
                    work.add_done_callback(lambda f: shared["op_failed"].append(
                        (time.monotonic(), repr(f.exception()))))
                    return work

                collective.allreduce = and_kill
            avg = m.allreduce(torch.full((300,), float(gid + 1)) * (step + 1)).result()
            if killing:
                collective.allreduce = allreduce
            try:
                committed = m.should_commit()
            except ExceededMaxRetriesError as e:
                shared["exceeded"] = (repr(e), len(configures), repr(collective.errored()))
                return
            log.append({"step": step, "committed": committed,
                        "participants": m.num_participants(),
                        "errored": repr(collective.errored())})
            if committed:
                params["w"].sub_(0.01 * avg)
                merged += m.num_participants() == 2
                if gid == 0 and step == 1:
                    shared["solo_done"].set()
                if inc == 1 and shared["target"] is None and merged == 1:
                    shared["target"] = m.current_step() + MERGED
            if m.num_participants() < 2:
                time.sleep(0.02)
        shared["final"][gid] = (m.current_step(), params["w"].clone())
    finally:
        m.shutdown()


# The lighthouse's timeouts of the crash test, with a margin that a loaded
# test machine cannot eat: a live group whose heartbeat or quorum request
# comes late must not be dropped from the quorum (the Baby would
# reconfigure).  The dead incarnation's heartbeat outlives it, so the
# restart's first quorum waits out the join timeout.
CRASH_HEARTBEAT_MS, CRASH_JOIN_MS = 5000, 1000


def test_a_crashed_child_fails_both_votes_until_max_retries_then_a_restart_heals() -> None:
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1,
                                  join_timeout_ms=CRASH_JOIN_MS,
                                  heartbeat_timeout_ms=CRASH_HEARTBEAT_MS)
    shared: Dict[str, Any] = {"target": None, "kill": True, "armed": False, "killed": [],
                              "op_failed": [],
                              "exceeded": None, "solo_done": threading.Event(), "logs": {},
                              "final": {}}
    errors: List[BaseException] = []

    def start(gid: int, inc: int, baby: bool) -> threading.Thread:
        def run() -> None:
            try:
                _ft_group(gid, inc, lh.address(), shared, baby)
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        t = threading.Thread(target=run)
        t.start()
        return t

    threads = [start(0, 0, False)]
    try:
        assert shared["solo_done"].wait(60), "group 0 never committed alone"
        threads.append(start(1, 0, True))
        threads[1].join(timeout=180)
        assert not threads[1].is_alive(), "the Baby group hung"
        assert not errors, errors
        assert shared["exceeded"] is not None, "the Baby group never exceeded max_retries"
        shared["kill"] = False
        threads.append(start(1, 1, True))
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads), "a group hung"
    finally:
        lh.shutdown()
    if errors:
        raise errors[0]
    # The op in flight failed within the Baby's timeout, naming the exit.
    (child, t_kill), = shared["killed"]
    (t_fail, exc), = shared["op_failed"]
    assert 0 <= t_fail - t_kill < T
    assert "collective subprocess died (exit code -9)" in exc
    exceeded, n_configures, latched = shared["exceeded"]
    assert "max_retries=2" in exceeded and "subprocess died" in latched
    # Nothing reconfigured after the kill: one configure in the Baby's life
    # (its quorum with group 0), whose child is the one killed.
    assert n_configures == 1
    baby_log = shared["logs"][(1, 0)]
    # Three failed votes: two logged, the third raised.
    fails = [r for r in baby_log if not r["committed"]]
    assert len(fails) == 2 and all("exit code -9" in r["errored"] for r in fails)
    assert sum(r["committed"] and r["participants"] == 2 for r in baby_log) >= MERGED
    # Group 0's votes failed with the Baby's, at the same step, and only
    # while the Baby group lived.
    kill_step = fails[0]["step"]
    assert all(r["step"] == kill_step for r in fails)
    g0_fails = [r for r in shared["logs"][(0, 0)] if not r["committed"]]
    assert len(g0_fails) == 3 and all(r["step"] == kill_step for r in g0_fails), g0_fails
    finals = shared["final"]
    assert sorted(finals) == [0, 1] and finals[0][0] == finals[1][0]
    assert torch.equal(finals[0][1], finals[1][1])
    merged_after = [r for r in shared["logs"][(1, 1)] if r["committed"] and r["participants"] == 2]
    assert len(merged_after) >= MERGED
