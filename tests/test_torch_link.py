"""The port's link shaper against the JAX package's.

- ``LinkShaper``: the same construction, ``delay_s``, counters after the
  same sends, ``set_rate`` (and its disable at 0 Mbps) and ``from_env`` as
  the JAX package's; a lone sender sleeps what the model says, and the
  lanes of one direction share one pacer.
- ``set_link_shaping`` mid-run slows the link and the sleep lands in
  ``lane_stats()["hops"]["flat"]["shape_s"]``, and on a collective
  configured unshaped too, on both engines; a ring2d tier direction is
  shaped alone.
- The shaped link counts wire bytes at the peer layer: the bf16 wire halves
  them, ``wire_dtype="auto"`` picks bf16 under ``TPUFT_SHAPED_LINK``, and
  the port's counts on either engine equal the JAX collective's.

Every thread has its own timeout.
"""

from __future__ import annotations

import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List

import numpy as np
import pytest

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch import collectives as C
from torchft_tpu_torch.collectives import LinkShaper, TCPCollective

HOST = "127.0.0.1"
_PREFIX = itertools.count()


@pytest.fixture(scope="module")
def jax_collectives():
    return import_reference("torchft_tpu.collectives")


@pytest.fixture(scope="module")
def store():
    server = _native.StoreServer(bind=f"{HOST}:0")
    yield server
    server.shutdown()


def _ranks(store, cols: List[Any], body: Callable[[Any, int], Any]) -> List[Any]:
    prefix = f"link/{next(_PREFIX)}"
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


@pytest.mark.parametrize("mbps, rtt", [(400.0, 1.0), (8.0, 0.0), (1e6, 20.0)])
def test_link_shaper_model_equals_the_jax_package(jax_collectives, mbps, rtt) -> None:
    port, ref = LinkShaper(mbps, rtt), jax_collectives.LinkShaper(mbps, rtt)
    assert (port.bytes_per_s, port.half_rtt_s) == (ref.bytes_per_s, ref.half_rtt_s)
    sizes = np.random.default_rng(5).integers(1, 2000, 6)
    for n in sizes:
        assert port.delay_s(int(n)) == ref.delay_s(int(n))
    fast = 1e9  # fast enough that the sends below do not sleep long
    port.set_rate(fast, 0.0)
    ref.set_rate(fast, 0.0)
    for n in sizes:
        port.on_send(int(n))
        ref.on_send(int(n))
    assert (port.bytes_sent, port.frames_sent) == (ref.bytes_sent, ref.frames_sent)
    assert port.bytes_sent == int(sizes.sum()) and port.frames_sent == len(sizes)
    for s in (port, ref):
        s.set_rate(0.0, 5.0)
    assert port.bytes_per_s == ref.bytes_per_s == float("inf")
    assert port.half_rtt_s == ref.half_rtt_s == 0.0
    port.reset_counters()
    assert (port.bytes_sent, port.frames_sent, port.wait_s) == (0, 0, 0.0)


def test_link_shaper_from_env_and_pacing(jax_collectives, monkeypatch) -> None:
    monkeypatch.delenv("TPUFT_SHAPED_LINK", raising=False)
    assert LinkShaper.from_env() is None and jax_collectives.LinkShaper.from_env() is None
    for spec in ("200:20", "8", "0.5:0"):
        monkeypatch.setenv("TPUFT_SHAPED_LINK", spec)
        port, ref = LinkShaper.from_env(), jax_collectives.LinkShaper.from_env()
        assert (port.bytes_per_s, port.half_rtt_s) == (ref.bytes_per_s, ref.half_rtt_s), spec
    # A lone sender: 40 000 bytes at 8 Mbps is 40 ms of serialisation, plus
    # half of a 10 ms RTT.
    s = LinkShaper(8.0, 10.0)
    t0 = time.monotonic()
    s.on_send(40_000)
    took = time.monotonic() - t0
    assert took >= 0.044 and s.wait_s >= 0.044 and took < 1.0


def test_lanes_of_one_direction_share_one_pacer(store, monkeypatch) -> None:
    monkeypatch.setenv("TPUFT_SHAPED_LINK", "1000000:0")

    def body(c, rank):
        c.allreduce([np.ones(1000, np.float32)]).wait(timeout=30)
        nxt, prv = c._next_lanes, c._prev_lanes
        return (len({id(p.shaper) for p in nxt}), len({id(p.shaper) for p in prv}),
                nxt[0].shaper is prv[0].shaper)

    for engine in ("py", "native"):
        cols = [TCPCollective(timeout=10.0, lanes=4, engine=engine, host=HOST) for _ in range(2)]
        for n_next, n_prev, same in _ranks(store, cols, body):
            assert (n_next, n_prev, same) == (1, 1, False)


@pytest.mark.parametrize("engine", ["py", "native"])
def test_set_link_shaping_mid_run(store, monkeypatch, engine) -> None:
    monkeypatch.setenv("TPUFT_SHAPED_LINK", "400:1")

    def body(c, rank):
        x = np.full(200_000, 1.0, dtype=np.float32)
        t0 = time.monotonic()
        c.allreduce([x], op="sum").wait(timeout=30)
        fast = time.monotonic() - t0
        c.set_link_shaping(8.0, 1.0)  # 50x slower outbound
        t0 = time.monotonic()
        c.allreduce([x], op="sum").wait(timeout=60)
        slow = time.monotonic() - t0
        return fast, slow, c.lane_stats()["hops"]["flat"]["shape_s"], c.ring_engine

    cols = [TCPCollective(timeout=30.0, lanes=1, wire_dtype="f32", engine=engine, host=HOST)
            for _ in range(2)]
    for fast, slow, shape_s, ran in _ranks(store, cols, body):
        assert ran == engine
        assert slow > fast * 3, (fast, slow)
        assert shape_s > 0.0


@pytest.mark.parametrize("engine", ["py", "native"])
def test_set_link_shaping_on_unshaped_collective(store, monkeypatch, engine) -> None:
    monkeypatch.delenv("TPUFT_SHAPED_LINK", raising=False)

    def body(c, rank):
        x = np.full(100_000, 1.0, dtype=np.float32)
        c.allreduce([x], op="sum").wait(timeout=30)
        before = c.lane_stats()["hops"]["flat"]["shape_s"]
        assert c._next.shaper is None
        c.set_link_shaping(16.0, 1.0)
        c.allreduce([x], op="sum").wait(timeout=60)
        return before, c.lane_stats()["hops"]["flat"]["shape_s"], c.ring_engine

    cols = [TCPCollective(timeout=30.0, lanes=1, wire_dtype="f32", engine=engine, host=HOST)
            for _ in range(2)]
    for before, after, ran in _ranks(store, cols, body):
        assert ran == engine and before == 0.0 and after > 0.0


@pytest.mark.parametrize("engine", ["py", "native"])
def test_set_link_shaping_of_one_ring2d_tier(store, monkeypatch, engine) -> None:
    monkeypatch.delenv("TPUFT_SHAPED_LINK", raising=False)

    def body(c, rank):
        c.set_link_shaping(40.0, 1.0, tier="row")
        c.allreduce([np.full(20_000, 1.0, np.float32)]).wait(timeout=60)
        hops = c.lane_stats()["hops"]
        return hops["row"]["shape_s"], hops["col"]["shape_s"], hops["flat"]["shape_s"]

    cols = [TCPCollective(timeout=30.0, lanes=1, engine=engine, host=HOST, topology="ring2d")
            for _ in range(4)]
    for row, col, flat in _ranks(store, cols, body):
        assert row > 0.0 and col == 0.0 and flat == 0.0


def _shaped_bytes(store, make, wire: str) -> int:
    payload = [np.ones(1 << 16, dtype=np.float32) for _ in range(2)]

    def body(c, rank):
        c.allreduce([payload[rank].copy()], op="sum").wait(timeout=30)
        return sum(p.shaper.bytes_sent for p in (c._next, c._prev)
                   if p is not None and p.shaper is not None)

    return sum(_ranks(store, [make(wire) for _ in range(2)], body))


@pytest.mark.parametrize("engine", ["py", "native"])
def test_shaped_link_halves_wire_bytes_with_bf16_and_counts_as_the_jax_package(
        store, jax_collectives, monkeypatch, engine) -> None:
    monkeypatch.setenv("TPUFT_SHAPED_LINK", "1000000:0")  # 1 Tbps, no RTT
    assert LinkShaper.from_env() is not None

    def port(wire):
        return TCPCollective(timeout=10.0, wire_dtype=wire, engine=engine, host=HOST)

    def ref(wire):
        return jax_collectives.TCPCollective(timeout=10.0, wire_dtype=wire, engine=engine,
                                             topology="ring", transport="tcp")

    counts = {(pkg, wire): _shaped_bytes(store, make, wire)
              for pkg, make in (("port", port), ("jax", ref))
              for wire in ("f32", "bf16", "auto")}
    f32, bf16, auto = (counts[("port", w)] for w in ("f32", "bf16", "auto"))
    assert f32 > bf16 * 1.8, (f32, bf16)
    assert auto == bf16
    for wire in ("f32", "bf16", "auto"):
        assert counts[("port", wire)] == counts[("jax", wire)], (wire, counts)


def test_shaped_link_knob_names_equal_the_jax_package(jax_collectives, monkeypatch) -> None:
    assert C.TPUFT_SHAPED_LINK_ENV == "TPUFT_SHAPED_LINK"
    assert C.HOP_RECORD_FIELDS == jax_collectives.HOP_RECORD_FIELDS
    # The collective's wire pick under a shaped link is the JAX package's.
    monkeypatch.setenv("TPUFT_SHAPED_LINK", "100:10")
    assert TCPCollective().wire_dtype == jax_collectives.TCPCollective().wire_dtype == "bf16"
