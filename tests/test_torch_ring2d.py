"""The port's 2-D ring (``topology="ring2d"``) against the JAX package's.

- ``_grid_shape`` equals the JAX package's for every world up to 64.
- ring2d against the flat ring at worlds 4, 6 and 9 and lanes 1 and 2:
  within f32 reassociation of the flat ring and the exact sum, bitwise
  equal across ranks, bitwise equal to an all-JAX ring2d of the same
  members, and ``lane_stats()`` with both tiers' byte counters.
- A mixed JAX + port ring2d on each engine pair, bitwise equal to the
  all-JAX one, for sum, avg, max and the int8 codec.
- The bf16 wire (replica-consistent, within bf16 of the flat ring, equal to
  the JAX ring2d bit for bit), bf16 tensors off the bf16 wire, and an
  integer payload (exact, full width on both tiers).
- A prime world degrades to the flat ring; ``"auto"`` runs the flat ring
  at 4 groups and ring2d at 8 (and at ``TPUFT_RING2D_MIN_GROUPS``).
- The tag-space audit of the port's module.
- Abort mid-op latches the survivors and closes every tier's sockets; the
  reconfigure at 3 (a prime) crosses back to the flat ring.

Every thread has its own timeout.
"""

from __future__ import annotations

import inspect
import itertools
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch import collectives as C
from torchft_tpu_torch.collectives import TCPCollective, _grid_shape

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


def _port(topology: str, lanes: int = 2, wire: str = "f32", engine: str = "auto",
          timeout: float = 30.0) -> TCPCollective:
    return TCPCollective(timeout=timeout, chunk_bytes=CHUNK, lanes=lanes, wire_dtype=wire,
                         engine=engine, host=HOST, topology=topology, transport="tcp")


def _jax(jc, topology: str, lanes: int = 2, wire: str = "f32", engine: str = "py"):
    return jc.TCPCollective(timeout=30.0, chunk_bytes=CHUNK, lanes=lanes, wire_dtype=wire,
                            engine=engine, topology=topology, transport="tcp")


def _ranks(store, cols: List[Any], body: Callable[[Any, int], Any]) -> List[Any]:
    prefix = f"ring2d/{next(_PREFIX)}"
    n = len(cols)

    def worker(rank: int) -> Any:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, n)
        try:
            return body(c, rank)
        finally:
            c.shutdown()

    with ThreadPoolExecutor(max_workers=n) as pool:
        futs = [pool.submit(worker, r) for r in range(n)]
        return [f.result(timeout=120) for f in futs]


def test_grid_shape_equals_the_jax_package(jax_collectives) -> None:
    for n in range(1, 65):
        assert _grid_shape(n) == jax_collectives._grid_shape(n), n
    assert _grid_shape(6) == (2, 3) and _grid_shape(9) == (3, 3) and _grid_shape(7) == (1, 7)
    for name in ("TPUFT_RING_TOPOLOGY_ENV", "TPUFT_RING2D_MIN_ENV", "_RING2D_DEFAULT_MIN",
                 "_TOPOLOGIES"):
        assert getattr(C, name) == getattr(jax_collectives, name), name


def _data(world: int, n: int = 6000, seed: int = 17) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(n).astype(np.float32) for _ in range(world)]


@pytest.mark.parametrize("world", [4, 6, 9])
@pytest.mark.parametrize("lanes", [1, 2])
def test_ring2d_matches_flat_ring_and_the_jax_ring2d(store, jax_collectives, world,
                                                     lanes) -> None:
    data = _data(world)

    def body(c, rank):
        out = c.allreduce([data[rank].copy()], op="sum").wait(timeout=60)[0]
        return out, c.topology, c.lane_stats()

    flat = _ranks(store, [_port("ring", lanes) for _ in range(world)], body)
    hier = _ranks(store, [_port("ring2d", lanes) for _ in range(world)], body)
    ref = _ranks(store, [_jax(jax_collectives, "ring2d", lanes) for _ in range(world)], body)
    expected = np.sum(data, axis=0)
    for rank in range(world):
        out, topo, stats = hier[rank]
        assert topo == "ring2d"
        np.testing.assert_allclose(out, expected, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out, flat[rank][0], rtol=1e-5, atol=1e-5)
        assert out.tobytes() == hier[0][0].tobytes()
        assert out.tobytes() == ref[rank][0].tobytes()
        assert stats["topology"] == "ring2d"
        assert set(stats["tiers"]) == {"row", "col"}
        rows, cols = _grid_shape(world)
        assert stats["tiers"]["row"]["size"] == cols and stats["tiers"]["col"]["size"] == rows
        for tier in stats["tiers"].values():
            assert len(tier["sent"]) == lanes and len(tier["recv"]) == lanes
            assert sum(tier["sent"]) > 0 and sum(tier["recv"]) > 0
        assert set(stats["hops"]) == {"flat", "row", "col"}
        assert stats["hops"]["row"]["hops"] > 0 and stats["hops"]["col"]["hops"] > 0


@pytest.mark.parametrize("jax_engine, port_engine",
                         [("py", "py"), ("native", "native"), ("py", "native")])
def test_mixed_jax_and_port_ring2d_bitwise(store, jax_collectives, jax_engine,
                                           port_engine) -> None:
    world = 4
    data = _data(world, 5003, seed=29)

    def body(c, rank):
        out = []
        for op, codec in (("sum", None), ("avg", None), ("max", None), ("sum", "int8")):
            kwargs = {} if codec is None else {"wire_codec": codec}
            out.append(np.asarray(c.allreduce([data[rank].copy()], op=op, **kwargs)
                                  .wait(timeout=60)[0]))
        return out, c.topology

    ref = _ranks(store, [_jax(jax_collectives, "ring2d") for _ in range(world)], body)
    mixed = _ranks(store, [_jax(jax_collectives, "ring2d", engine=jax_engine) if r % 2 == 0
                           else _port("ring2d", engine=port_engine) for r in range(world)], body)
    for rank in range(world):
        assert mixed[rank][1] == "ring2d"
        for a, b in zip(ref[rank][0], mixed[rank][0]):
            assert a.tobytes() == b.tobytes(), rank
    np.testing.assert_array_equal(mixed[0][0][2], np.max(data, axis=0))


@pytest.mark.parametrize("engine", ["py", "native"])
def test_ring2d_bf16_wire_replica_consistent_and_equal_to_jax(store, jax_collectives,
                                                              engine) -> None:
    world = 4
    data = _data(world, 4096, seed=23)

    def body(c, rank):
        return c.allreduce([data[rank].copy()], op="sum").wait(timeout=60)[0]

    flat = _ranks(store, [_port("ring", wire="bf16", engine=engine) for _ in range(world)], body)
    hier = _ranks(store, [_port("ring2d", wire="bf16", engine=engine) for _ in range(world)],
                  body)
    ref = _ranks(store, [_jax(jax_collectives, "ring2d", wire="bf16") for _ in range(world)],
                 body)
    expected = np.sum(data, axis=0)
    for rank in range(world):
        assert hier[rank].tobytes() == hier[0].tobytes() == ref[rank].tobytes()
        np.testing.assert_allclose(hier[rank], expected, rtol=0.02, atol=0.02 * world)
        np.testing.assert_allclose(hier[rank], flat[rank], rtol=0.02, atol=0.02 * world)


def test_ring2d_bf16_tensors_off_the_bf16_wire(store) -> None:
    world = 4
    rng = np.random.default_rng(31)
    data = [torch.from_numpy(rng.standard_normal(2048).astype(np.float32)).to(torch.bfloat16)
            for _ in range(world)]

    def body(c, rank):
        return c.allreduce([data[rank].clone()], op="sum").wait(timeout=60)[0]

    results = _ranks(store, [_port("ring2d", wire="bf16") for _ in range(world)], body)
    expected = torch.stack([d.float() for d in data]).sum(0)
    for out in results:
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), expected, rtol=0.02, atol=0.02 * world)
        assert torch.equal(out.view(torch.int16), results[0].view(torch.int16))


def test_ring2d_integer_payload_bypasses_compression(store) -> None:
    world, n = 6, 4096
    payload = np.arange(n, dtype=np.int64)

    def body(c, rank):
        out = c.allreduce([payload * (rank + 1)], op="sum").wait(timeout=60)[0]
        return out, c.lane_stats()

    total = sum(range(1, world + 1))
    for out, stats in _ranks(store, [_port("ring2d", wire="bf16") for _ in range(world)], body):
        np.testing.assert_array_equal(out, payload * total)
        assert out.dtype == np.int64
        row = stats["tiers"]["row"]
        assert sum(row["sent"]) >= payload.nbytes * (row["size"] - 1) // row["size"], stats
        assert sum(stats["tiers"]["col"]["sent"]) > 0


def test_ring2d_prime_world_degrades_to_flat_ring(store) -> None:
    def body(c, rank):
        out = c.allreduce([np.full(64, float(rank + 1), np.float32)]).wait(timeout=30)[0]
        return out, c.topology, c._row_tier

    for out, topo, row in _ranks(store, [_port("ring2d") for _ in range(5)], body):
        assert topo == "ring" and row is None
        np.testing.assert_array_equal(out, np.full(64, 15.0, np.float32))


def test_auto_topology_crossover(store, monkeypatch) -> None:
    def body(c, rank):
        c.allreduce([np.ones(32, np.float32)]).wait(timeout=30)
        return c.topology

    assert set(_ranks(store, [_port("auto", lanes=1) for _ in range(4)], body)) == {"ring"}
    assert set(_ranks(store, [_port("auto", lanes=1) for _ in range(8)], body)) == {"ring2d"}
    monkeypatch.setenv("TPUFT_RING2D_MIN_GROUPS", "4")
    assert set(_ranks(store, [_port("auto", lanes=1) for _ in range(4)], body)) == {"ring2d"}
    monkeypatch.setenv("TPUFT_RING_TOPOLOGY", "ring")
    assert TCPCollective(host=HOST)._resolve_topology(16) == "ring"


def test_tag_space_tier_partition_static_audit(jax_collectives) -> None:
    subs = (C._SUB_RS, C._SUB_AG, C._SUB_GATHER, C._SUB_COL_RS, C._SUB_COL_AG)
    assert subs == (jax_collectives._SUB_RS, jax_collectives._SUB_AG,
                    jax_collectives._SUB_GATHER, jax_collectives._SUB_COL_RS,
                    jax_collectives._SUB_COL_AG)
    assert len(set(subs)) == len(subs) and max(subs) < C._TAGS_PER_STRIPE
    assert max(C._SUB_RS, C._SUB_AG, C._SUB_GATHER) < min(C._SUB_COL_RS, C._SUB_COL_AG)
    assert C._TAGS_PER_OP == C._TAGS_PER_STRIPE * (C._MAX_STRIPES + 1)
    assert (C._MAX_STRIPES - 1) * C._TAGS_PER_STRIPE + max(subs) < C._TAGS_PER_OP
    # No literal offset on a tag base: every one is a named subtag.
    src = inspect.getsource(C)
    assert {int(m) for m in re.findall(r"tag_base\s*\+\s*(\d+)", src)} <= set(subs)
    for ch in ("_CH_RING", "_CH_P2P", "_CH_ROW", "_CH_COL"):
        assert getattr(C, ch) == getattr(jax_collectives.TCPCollective, ch), ch


@pytest.mark.parametrize("engine", ["py", "native"])
def test_ring2d_abort_latches_and_reconfigure_crosses_crossover(store, engine) -> None:
    world, lanes = 4, 2
    prefix, prefix2 = f"ring2d/a/{next(_PREFIX)}", f"ring2d/a/{next(_PREFIX)}"
    cols = [_port("ring2d", lanes, engine=engine, timeout=5.0) for _ in range(world)]
    barrier = threading.Barrier(world)
    old: Dict[int, list] = {}

    def worker(rank: int) -> str:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, world)
        assert c.topology == "ring2d" and set(c.lane_stats()["tiers"]) == {"row", "col"}
        old[rank] = (c._next_lanes + c._prev_lanes + c._row_tier.peers()
                     + c._col_tier.peers())
        x = np.ones(8192, dtype=np.float32)
        c.allreduce([x]).wait(timeout=20)
        barrier.wait(timeout=20)
        if rank == world - 1:
            c.abort()
            return "dead"
        assert c.allreduce([x]).exception(timeout=20) is not None
        assert c.errored() is not None
        return "latched"

    with ThreadPoolExecutor(max_workers=world) as pool:
        results = [f.result(timeout=90) for f in [pool.submit(worker, r) for r in range(world)]]
    assert results.count("latched") == world - 1

    def recover(rank: int) -> np.ndarray:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix2}", rank, 3)
        assert c.errored() is None and c.topology == "ring"
        assert c._row_tier is None and c._col_tier is None
        assert all(p.sock.fileno() == -1 for p in old[rank])
        out = c.allreduce([np.full(4, float(rank + 1), np.float32)]).wait(timeout=20)[0]
        c.shutdown()
        return out

    with ThreadPoolExecutor(max_workers=3) as pool:
        for f in [pool.submit(recover, r) for r in range(3)]:
            np.testing.assert_array_equal(f.result(timeout=90), np.full(4, 6.0, np.float32))
    cols[world - 1].shutdown()
