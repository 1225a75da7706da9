"""The port's same-host shm lanes against the JAX package's.

- Segment layout: a port ``_ShmRing`` producer feeds a JAX ``_ShmRing``
  consumer through one segment file and the reverse, frames larger than
  the ring included; the header constants are the JAX package's.
- A stale segment (a wrong token, a wrong magic) is refused at attach.
- Roundtrip and unlink: 2 port ranks on shm lanes resolve to shm, match
  the TCP ring bitwise, hold ``tpuft_torch-*`` segments while armed (never
  ``tpuft-*``, the JAX package's prefix) and unlink every one at shutdown.
- A peer SIGKILLed mid-op (a subprocess port rank): the survivor latches,
  ``abort()`` reclaims both ends' segments, and a fresh configure heals
  onto shm again.
- shm bitwise equal to TCP on each engine and on a mixed-engine ring, over
  the f32 and bf16 wires, the int8 codec and max.
- A mixed JAX + port shm ring on either engine, bitwise equal to an all-JAX
  TCP ring (the JAX ranks' segments made under the port's prefix by a
  copy of its ``_create_shm_segment`` that differs in the name alone, so
  the JAX tests' machine-wide ``tpuft-*`` counts never see them).
- Incremental reconfigure keeps a surviving edge's segments: a churn walk
  on shm reuses lanes, keeps their paths, and leaves no segment behind;
  the JAX shm churn's walk (3 -> 2 -> 3 -> 2 -> 3 members) on port ranks.

Every thread and subprocess has its own timeout.
"""

from __future__ import annotations

import itertools
import os
import select
import socket
import struct
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import pytest

from torch_port_ref import REPO, import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch import collectives as C
from torchft_tpu_torch.collectives import TCPCollective

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


def _make_segment(path: str, token: int, cap: int = 4096) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<QQQQI", C._SHM_MAGIC, token, 0, 0, 0))
        f.write(b"\x00" * (C._SHM_HDR + cap - f.tell()))


def _port_segments() -> set:
    return {p for p in os.listdir("/dev/shm") if p.startswith("tpuft_torch-")}


def test_segment_layout_constants_equal_the_jax_package(jax_collectives) -> None:
    for name in ("_SHM_MAGIC", "_SHM_HDR", "_SHM_TOKEN_OFF", "_SHM_HEAD_OFF", "_SHM_TAIL_OFF",
                 "_SHM_POISON_OFF", "_SHM_RING_BYTES_DEFAULT", "TPUFT_RING_TRANSPORT_ENV",
                 "TPUFT_SHM_RING_BYTES_ENV", "_TRANSPORTS"):
        assert getattr(C, name) == getattr(jax_collectives, name), name
    assert C._SHM_REQ.format == jax_collectives._SHM_REQ.format
    assert C._SHM_REP.format == jax_collectives._SHM_REP.format
    # The longest name the port makes fits the handshake's 64-byte field:
    # a 7-digit pid, a 6-digit generation, 4-digit ranks.
    longest = (f"{C._SHM_PREFIX}{4194304}-g{999999}-r{9999}to{9999}-c{3}-l{7}-"
               f"{os.urandom(4).hex()}")
    assert len(longest) <= 64 and not longest.startswith("tpuft-")


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
@pytest.mark.parametrize("nbytes", [64, 10_000])
def test_segment_layout_parity_across_packages(tmp_path, jax_collectives, writer, reader,
                                               nbytes) -> None:
    """One segment, a producer of one package and a consumer of the other:
    10 000 bytes through a 4096-byte ring wrap it twice."""
    rings = {"port": C._ShmRing, "jax": jax_collectives._ShmRing}
    path = str(tmp_path / "seg")
    _make_segment(path, token=77)
    a, b = socket.socketpair()
    payload = np.random.default_rng(3).integers(0, 256, nbytes, dtype=np.uint8)
    try:
        tx = rings[writer](path, 77, a)
        rx = rings[reader](path, 77, b)
        got = bytearray(nbytes)
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(rx.read_into, memoryview(got), 10.0)
            tx.write(payload, timeout=10.0)
            fut.result(timeout=20)
        assert bytes(got) == payload.tobytes()
        # Both packages' cursors read the same header.
        head, tail = struct.unpack_from("<QQ", open(path, "rb").read(32), 16)
        assert head == tail == nbytes
        tx.close()
        rx.close()
    finally:
        a.close()
        b.close()


def test_stale_segment_refused(tmp_path) -> None:
    path = str(tmp_path / "seg")
    _make_segment(path, token=1234)
    a, b = socket.socketpair()
    try:
        with pytest.raises(ConnectionError, match="stale shm segment"):
            C._ShmRing(path, 9999, a)
        bad = str(tmp_path / "bad")
        _make_segment(bad, token=1234)
        with open(bad, "r+b") as f:
            f.write(b"\x00" * 8)
        with pytest.raises(ConnectionError, match="stale shm segment"):
            C._ShmRing(bad, 1234, a)
        tx, rx = C._ShmRing(path, 1234, a), C._ShmRing(path, 1234, b)
        tx.write(np.arange(64, dtype=np.uint8), timeout=5.0)
        got = bytearray(64)
        rx.read_into(memoryview(got), timeout=5.0)
        assert bytes(got) == bytes(range(64))
        # A poisoned, drained ring fails the consumer at once.
        tx.close()
        with pytest.raises(ConnectionError, match="poisoned"):
            rx.read_into(memoryview(bytearray(1)), timeout=5.0)
        rx.close()
    finally:
        a.close()
        b.close()


def _payloads(rank: int) -> List[np.ndarray]:
    rng = np.random.default_rng(900 + rank)
    return [(rng.standard_normal(3001) * (rank + 1)).astype(np.float32)]


def _ring(store, cols, ops=(("sum", None),), mid=None) -> Dict[int, dict]:
    prefix = f"shm/{next(_PREFIX)}"
    n = len(cols)

    def worker(rank: int) -> dict:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, n)
        if mid is not None:
            mid(rank, c)
        out = []
        for op, codec in ops:
            kwargs = {} if codec is None else {"wire_codec": codec}
            out += [np.asarray(a) for a in
                    c.allreduce([p.copy() for p in _payloads(rank)], op=op, **kwargs).wait(
                        timeout=30)]
        return {"out": out, "transport": c.ring_transport, "engine": c.ring_engine}

    try:
        with ThreadPoolExecutor(max_workers=n) as pool:
            futs = [pool.submit(worker, r) for r in range(n)]
            return {r: f.result(timeout=90) for r, f in enumerate(futs)}
    finally:
        for c in cols:
            c.shutdown()


def _port(engine: str, transport: str, wire: str = "f32", lanes: int = 2) -> TCPCollective:
    return TCPCollective(timeout=20.0, chunk_bytes=CHUNK, lanes=lanes, engine=engine,
                         host=HOST, transport=transport, wire_dtype=wire, topology="ring")


def _bits(a: List[np.ndarray], b: List[np.ndarray], ctx: str) -> None:
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), ctx


@pytest.mark.parametrize("engine", ["py", "native"])
def test_shm_lanes_roundtrip_and_unlink(store, engine) -> None:
    seen: Dict[int, set] = {}

    def mid(rank: int, c: TCPCollective) -> None:
        seen[rank] = set(c._shm_paths)

    tcp = _ring(store, [_port(engine, "tcp") for _ in range(2)], (("sum", "int8"),))
    shm = _ring(store, [_port(engine, "shm") for _ in range(2)], (("sum", "int8"),), mid=mid)
    assert {r["transport"] for r in shm.values()} == {"shm"}
    assert {r["engine"] for r in shm.values()} == {engine}
    for rank in range(2):
        _bits(tcp[rank]["out"], shm[rank]["out"], f"rank {rank}")
    # 2 lanes x 2 directed links, tracked by both ends, under the port's
    # prefix only; all gone after shutdown.
    paths = seen[0] | seen[1]
    assert len(paths) == 4 and seen[0] == seen[1]
    assert all(os.path.basename(p).startswith("tpuft_torch-") for p in paths)
    assert not [p for p in paths if os.path.exists(p)], "leaked shm segments"


@pytest.mark.parametrize("engines", [("py", "py"), ("native", "native"), ("native", "py")])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_shm_bitwise_equals_tcp(store, engines, wire) -> None:
    ops = (("sum", None), ("avg", None), ("max", None), ("sum", "int8"), ("sum", "int4"))
    tcp = _ring(store, [_port("py", "tcp", wire) for _ in range(2)], ops)
    shm = _ring(store, [_port(e, "shm", wire) for e in engines], ops)
    assert [shm[r]["engine"] for r in range(2)] == list(engines)
    assert {r["transport"] for r in shm.values()} == {"shm"}
    for rank in range(2):
        _bits(tcp[rank]["out"], shm[rank]["out"], f"{engines} {wire} rank {rank}")


def _jax_segment_under_the_ports_prefix(jc):
    """The JAX package's ``TCPCollective._create_shm_segment``, with the
    port's name prefix in place of ``tpuft-``."""

    def create(self, their_rank: int, channel: int, lane: int) -> tuple:
        name = (f"tpuft_torch-ref-{os.getpid()}-g{self._generation}-r{their_rank}"
                f"to{self._rank}-c{channel}-l{lane}-{os.urandom(4).hex()}")
        path = "/dev/shm/" + name
        try:
            os.unlink(path)
        except FileNotFoundError:
            pass
        cap = jc._shm_ring_bytes_from_env()
        fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.ftruncate(fd, jc._SHM_HDR + cap)
            token = int.from_bytes(os.urandom(8), "little") | 1
            os.pwrite(fd, struct.pack("<QQQQI", jc._SHM_MAGIC, token, 0, 0, 0), 0)
        except OSError:
            os.close(fd)
            try:
                os.unlink(path)
            except OSError:
                pass
            raise
        os.close(fd)
        return path, token

    return create


@pytest.mark.parametrize("port_rank", [0, 1])
@pytest.mark.parametrize("jax_engine, port_engine",
                         [("py", "py"), ("native", "native"), ("py", "native"),
                          ("native", "py")])
def test_mixed_jax_and_port_shm_ring_bitwise(store, jax_collectives, monkeypatch, port_rank,
                                             jax_engine, port_engine) -> None:
    monkeypatch.setattr(jax_collectives.TCPCollective, "_create_shm_segment",
                        _jax_segment_under_the_ports_prefix(jax_collectives))
    ops = (("sum", None), ("max", None), ("sum", "int8"))

    def jax(engine: str, transport: str):
        return jax_collectives.TCPCollective(timeout=20.0, chunk_bytes=CHUNK, lanes=2,
                                             wire_dtype="f32", topology="ring", engine=engine,
                                             transport=transport)

    seen: Dict[int, set] = {}

    def mid(rank: int, c) -> None:
        seen[rank] = set(c._shm_paths)

    ref = _ring(store, [jax("py", "tcp") for _ in range(2)], ops)
    cols = [jax(jax_engine, "shm") for _ in range(2)]
    cols[port_rank] = _port(port_engine, "shm")
    got = _ring(store, cols, ops, mid=mid)
    assert {r["transport"] for r in got.values()} == {"shm"}
    for rank in range(2):
        _bits(ref[rank]["out"], got[rank]["out"], f"rank {rank}")
    paths = seen[0] | seen[1]
    assert len(paths) == 4
    assert all(os.path.basename(p).startswith("tpuft_torch-") for p in paths)
    assert not [p for p in paths if os.path.exists(p)], "leaked shm segments"


_CHILD_SRC = """
import sys, time
import numpy as np
sys.path.insert(0, sys.argv[4])
from torchft_tpu_torch.collectives import TCPCollective
addr, prefix, mode = sys.argv[1], sys.argv[2], sys.argv[3]
c = TCPCollective(timeout=30.0, lanes=2, transport="shm", chunk_bytes=4 << 10, host="127.0.0.1")
c.configure(addr + "/" + prefix, 1, 2)
out = c.allreduce([np.full(2048, 2.0, dtype=np.float32)]).wait(timeout=30)
assert float(out[0][0]) == 3.0, out[0][0]
print("READY", flush=True)
if mode == "hang":
    time.sleep(120)
c.shutdown()
print("DONE", flush=True)
"""


def _spawn_child(store, prefix: str, mode: str) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-c", _CHILD_SRC, store.address(), prefix, mode, REPO],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=dict(os.environ),
    )


def _readline(proc: subprocess.Popen, timeout: float) -> str:
    """The child's next line of output, or "" after ``timeout`` seconds."""
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    return proc.stdout.readline() if ready else ""


def test_shm_peer_sigkill_cleanup_and_heal(store) -> None:
    prefix, prefix2 = f"shm/kill/{next(_PREFIX)}", f"shm/kill/{next(_PREFIX)}"
    c = TCPCollective(timeout=10.0, lanes=2, transport="shm", chunk_bytes=CHUNK, host=HOST)
    child = _spawn_child(store, prefix, mode="hang")
    try:
        c.configure(f"{store.address()}/{prefix}", 0, 2)
        assert c.ring_transport == "shm"
        paths = set(c._shm_paths)
        assert len(paths) == 4 and all(os.path.exists(p) for p in paths)
        out = c.allreduce([np.full(2048, 1.0, dtype=np.float32)]).wait(timeout=30)
        assert float(out[0][0]) == 3.0
        line = _readline(child, 60.0)
        assert "READY" in line, line
        # The child sleeps and never joins: the op waits on the ring, then
        # the SIGKILL lands and the liveness poll (socket EOF) fails it.
        work = c.allreduce([np.full(2048, 1.0, dtype=np.float32)])
        time.sleep(0.2)
        child.kill()
        assert work.exception(timeout=30) is not None, "expected a failure after the SIGKILL"
        assert c.errored() is not None
    finally:
        if child.poll() is None:
            child.kill()
        child.wait(timeout=10)
        child.stdout.close()
        # The survivor's abort reclaims both ends' segments (and runs on a
        # failed assertion too, so nothing is left behind).
        c.abort()
    assert not [p for p in paths if os.path.exists(p)], "the survivor left segments"

    child2 = _spawn_child(store, prefix2, mode="exit")
    try:
        c.configure(f"{store.address()}/{prefix2}", 0, 2)
        assert c.errored() is None and c.ring_transport == "shm"
        paths2 = set(c._shm_paths)
        out = c.allreduce([np.full(2048, 1.0, dtype=np.float32)]).wait(timeout=30)
        assert float(out[0][0]) == 3.0
        assert child2.wait(timeout=30) == 0, child2.stdout.read()
    finally:
        if child2.poll() is None:
            child2.kill()
            child2.wait(timeout=10)
        child2.stdout.close()
        c.shutdown()
    assert paths2 and not [p for p in paths2 if os.path.exists(p)], "leaked after the heal"


@pytest.mark.parametrize("engine", ["py", "native"])
def test_incremental_reconfigure_reuses_shm_segments(store, engine) -> None:
    """Members {0, 1, 2} as ranks 0-2, then {0, 1} as ranks 0-1: the 0 -> 1
    edge survives with its segments; sums stay exact on every rank."""
    members = {m: _port(engine, "shm") for m in range(3)}
    kept: Dict[int, set] = {}
    results: Dict[int, list] = {}
    all_paths: set = set()

    def generation(alive: List[int]) -> None:
        prefix = f"shm/churn/{next(_PREFIX)}"

        def worker(rank: int) -> None:
            c = members[alive[rank]]
            c.configure(f"{store.address()}/{prefix}", rank, len(alive))
            assert c.ring_transport == "shm"
            kept.setdefault(alive[rank], set()).update(c._shm_paths)
            all_paths.update(c._shm_paths)
            x = np.full(1500, float(alive[rank] + 1), np.float32)
            out = c.allreduce([x]).wait(timeout=30)[0]
            results.setdefault(alive[rank], []).append(
                (out, dict(c.last_configure), set(c._shm_paths)))

        with ThreadPoolExecutor(max_workers=len(alive)) as pool:
            for f in [pool.submit(worker, r) for r in range(len(alive))]:
                f.result(timeout=90)

    try:
        generation([0, 1, 2])
        before = {m: set(members[m]._shm_paths) for m in (0, 1)}
        members[2].shutdown()
        generation([0, 1])
    finally:
        for c in members.values():
            c.shutdown()
    for m in (0, 1):
        first, second = results[m]
        np.testing.assert_array_equal(first[0], np.full(1500, 6.0, np.float32))
        np.testing.assert_array_equal(second[0], np.full(1500, 3.0, np.float32))
        assert second[1]["mode"] == "incremental" and second[1]["reused_lanes"] == 2, second[1]
        # The kept edge's two segments kept their paths.
        assert len(before[m] & second[2]) == 2
    assert all(os.path.basename(p).startswith("tpuft_torch-") for p in all_paths)
    assert not [p for p in all_paths if os.path.exists(p)], "leaked shm segments"
    assert not _port_segments() & {os.path.basename(p) for p in all_paths}


@pytest.mark.parametrize("engine", ["py", "native"])
def test_shm_churn_walk_reuses_and_cleans_up(store, engine) -> None:
    """The JAX shm churn's walk on port ranks: members {0, 1, 2}, 2 leaves,
    3 joins, 0 leaves, 4 joins; every generation on shm lanes, exact on
    every rank, at least one incremental reuse, no segment left."""
    members: Dict[int, TCPCollective] = {i: _port(engine, "shm") for i in range(3)}
    paths: set = set()
    reused = 0
    try:
        for kind, mid in ((None, None), ("leave", 2), ("join", 3), ("leave", 0), ("join", 4)):
            if kind == "leave":
                members.pop(mid).shutdown()
            elif kind == "join":
                members[mid] = _port(engine, "shm")
            live = sorted(members)
            prefix = f"shm/walk/{next(_PREFIX)}"

            def worker(rank: int) -> tuple:
                c = members[live[rank]]
                c.configure(f"{store.address()}/{prefix}", rank, len(live))
                out = c.allreduce([np.full(257, float(rank + 1), np.float32)]).wait(timeout=30)[0]
                return out, c.ring_transport, c.last_configure["reused_lanes"], set(c._shm_paths)

            with ThreadPoolExecutor(max_workers=len(live)) as pool:
                got = [f.result(timeout=90)
                       for f in [pool.submit(worker, r) for r in range(len(live))]]
            total = sum(range(1, len(live) + 1))
            for out, transport, reuse, p in got:
                assert transport == "shm"
                np.testing.assert_array_equal(out, np.full(257, float(total), np.float32))
                reused += reuse
                paths |= p
    finally:
        for c in members.values():
            c.shutdown()
    assert reused > 0
    assert all(os.path.basename(p).startswith("tpuft_torch-") for p in paths)
    assert not [p for p in paths if os.path.exists(p)], "leaked shm segments"
