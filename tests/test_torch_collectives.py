"""The port's data plane against the JAX package's, bitwise.

- Mixed rings: a JAX ``TCPCollective`` rank and a port rank on one store,
  each on either engine, at 1, 2 and 4 lanes, on the f32 and the bf16 wire,
  summing and averaging the JAX ring-engine tests' payloads (an odd length,
  a two-array bucket, a 0-d scalar): every rank's results bitwise equal an
  all-JAX Python-engine ring's.
- Port-only rings: the native engine bitwise equal to the Python engine.
- The bf16 wire's encode bitwise equal to ``ml_dtypes``' cast (imported
  here, on the reference side only).
- Abort: a mid-op abort latches the error on the survivors, every dup'd fd
  of the native engine closes, and a reconfigure runs a fresh ring.
- Engine selection: ``engine="native"`` raises where the engine cannot be
  built; ``"auto"`` warns once and runs the Python engine.
- Incremental reconfiguration (tests/test_elastic_churn.py's soak, parity
  and world-2 cases, on both engines): every generation of a churn walk
  bitwise equal on every rank, with lanes reused and no fd leaked; the
  incremental and the full path bitwise equal to an all-JAX walk; a mixed
  JAX + port ring through the walk, with the knob on or off on each side,
  equal to an all-JAX ring in bits and in each member's
  ``last_configure``; a rank that missed a quorum does not reuse the edge
  its neighbour closed meanwhile.
- The int8 / int4 wire codecs: the quantizers and the nibble packing
  bitwise equal to the JAX package's (NaN, infinities and all-zero inputs
  included); codec allreduces in mixed rings on every engine pair at 1, 2
  and 4 lanes, and port-only rings on either engine, bitwise equal to an
  all-JAX Python-engine ring; ``wire_nbytes`` at most 0.27x (int8) and
  0.13x (int4) the f32 wire; integer payloads and unknown codecs refused.
  bf16 tensors off the bf16 wire sum in bf16 as the JAX engine's
  ``ml_dtypes`` arrays do.

Payloads are small with ``chunk_bytes=4 << 10``, so the striped paths run
several stripes.
"""

from __future__ import annotations

import gc
import itertools
import logging
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch import collectives as C
from torchft_tpu_torch.collectives import TCPCollective, bf16_decode, bf16_encode

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


def _payloads(rank: int) -> List[List[np.ndarray]]:
    """tests/test_ring_engine.py's payloads: an odd length (uneven chunk and
    stripe boundaries), a two-array bucket, and a 0-d scalar (all-empty
    stripes)."""
    rng = np.random.default_rng(1000 + rank)
    big = (rng.standard_normal(6311) * (rank + 1)).astype(np.float32)
    small = np.full((7,), 0.25 * (rank + 1), dtype=np.float32)
    scalar = np.asarray(np.float32(0.1) * (rank + 1))
    return [[big, small], [scalar]]


def _make(kind: str, engine: str, lanes: int, wire: str, jax_collectives, timeout: float = 30.0):
    if kind == "jax":
        return jax_collectives.TCPCollective(
            timeout=timeout, chunk_bytes=CHUNK, wire_dtype=wire, lanes=lanes, topology="ring",
            engine=engine, transport="tcp",
        )
    return TCPCollective(timeout=timeout, chunk_bytes=CHUNK, wire_dtype=wire, lanes=lanes,
                         engine=engine, host=HOST)


def _run_ring(store, cols, codec=None) -> Dict[int, dict]:
    """Configures ``cols`` as one ring and runs sum and avg over every
    payload on each rank (under ``codec`` when given); returns {rank:
    {"out": [...], "engine": ...}}."""
    prefix = f"mixed/{next(_PREFIX)}"
    world = len(cols)
    out: Dict[int, dict] = {}

    def worker(rank: int) -> None:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, world)
        got: List[np.ndarray] = []
        kwargs = {} if codec is None else {"wire_codec": codec}
        for arrays in _payloads(rank):
            for op in ("sum", "avg"):
                got += [np.asarray(a) for a in
                        c.allreduce(arrays, op=op, **kwargs).wait(timeout=30)]
        out[rank] = {"out": got, "engine": c.ring_engine}

    try:
        with ThreadPoolExecutor(max_workers=world) as pool:
            for f in [pool.submit(worker, r) for r in range(world)]:
                f.result(timeout=90)
    finally:
        for c in cols:
            c.shutdown()
    return out


def _assert_bitwise(a: List[np.ndarray], b: List[np.ndarray], ctx: str) -> None:
    """tests/test_ring_engine.py's ``_assert_bitwise``."""
    assert len(a) == len(b), ctx
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and x.shape == y.shape, f"{ctx} out[{i}]"
        xb = np.ascontiguousarray(x).view(np.uint8)
        yb = np.ascontiguousarray(y).view(np.uint8)
        assert (xb == yb).all(), f"{ctx} out[{i}] differs bitwise"


_REFERENCE: Dict[tuple, Dict[int, dict]] = {}


def _all_jax_py(store, lanes: int, wire: str, jax_collectives) -> Dict[int, dict]:
    key = (lanes, wire)
    if key not in _REFERENCE:
        _REFERENCE[key] = _run_ring(
            store, [_make("jax", "py", lanes, wire, jax_collectives) for _ in range(2)])
    return _REFERENCE[key]


@pytest.mark.parametrize("port_rank", [0, 1])
@pytest.mark.parametrize("jax_engine, port_engine",
                         [("py", "py"), ("py", "native"), ("native", "py"), ("native", "native")])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_mixed_jax_and_port_ring_bitwise(store, jax_collectives, lanes, wire, jax_engine,
                                         port_engine, port_rank) -> None:
    ref = _all_jax_py(store, lanes, wire, jax_collectives)
    cols = [_make("jax", jax_engine, lanes, wire, jax_collectives) for _ in range(2)]
    cols[port_rank] = _make("port", port_engine, lanes, wire, jax_collectives)
    got = _run_ring(store, cols)
    assert got[port_rank]["engine"] == port_engine
    assert got[1 - port_rank]["engine"] == jax_engine
    for rank in range(2):
        _assert_bitwise(ref[rank]["out"], got[rank]["out"],
                        f"lanes={lanes} wire={wire} jax={jax_engine} port={port_engine} "
                        f"port_rank={port_rank} rank={rank}")


@pytest.mark.parametrize("world, lanes", [(2, 1), (2, 2), (2, 4), (3, 1), (3, 2)])
@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_port_native_engine_bitwise_equals_python_engine(store, world, lanes, wire) -> None:
    outs = {}
    for engine in ("py", "native"):
        got = _run_ring(store, [_make("port", engine, lanes, wire, None) for _ in range(world)])
        assert {r["engine"] for r in got.values()} == {engine}
        outs[engine] = got
    for rank in range(world):
        _assert_bitwise(outs["py"][rank]["out"], outs["native"][rank]["out"],
                        f"world={world} lanes={lanes} wire={wire} rank={rank}")
        # Every rank decodes the same bits (the commit protocol's premise).
        _assert_bitwise(outs["native"][0]["out"], outs["native"][rank]["out"], f"rank={rank}")


def test_bf16_encode_is_ml_dtypes_cast_bitwise() -> None:
    import ml_dtypes

    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(50_000).astype(np.float32),
        (rng.standard_normal(1000) * 1e-39).astype(np.float32),  # subnormals
        np.frombuffer(rng.integers(0, 2**32, 50_000, dtype=np.uint32).tobytes(), np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 3.4e38, -3.4e38,
                  1 + 2**-8, 1 + 3 * 2**-8, 1.0 + 2**-9], dtype=np.float32),
    ])
    with np.errstate(invalid="ignore"):
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = bf16_encode(x)
    assert got.dtype == np.uint16 and got.shape == x.shape
    assert (got == want).all(), np.flatnonzero(got != want)[:10]
    # Decode is exact: each bf16 value comes back as itself.
    np.testing.assert_array_equal(bf16_decode(want).view(np.uint32),
                                  want.view(ml_dtypes.bfloat16).astype(np.float32).view(np.uint32))


def test_bf16_tensors_ride_the_bf16_wire_as_the_jax_bf16_arrays_do(store, jax_collectives) -> None:
    """A device-prepped bucket reaches the collective as bf16: the port
    (a CPU bf16 tensor) and the JAX package (an ml_dtypes array) reduce it
    to the same bits, accumulating in f32."""
    import ml_dtypes

    base = [np.linspace(-3, 3, 5001, dtype=np.float32) * (r + 1) for r in range(2)]
    results = {}
    for kind in ("jax", "port"):
        cols = [_make(kind, "native", 2, "bf16", jax_collectives) for _ in range(2)]
        prefix = f"bf16in/{next(_PREFIX)}"

        def worker(rank: int, cols=cols, kind=kind, prefix=prefix) -> np.ndarray:
            cols[rank].configure(f"{store.address()}/{prefix}", rank, 2)
            bits = base[rank].astype(ml_dtypes.bfloat16)
            arg = (bits if kind == "jax"
                   else torch.from_numpy(bits.view(np.uint16).view(np.int16)).view(torch.bfloat16))
            (out,) = cols[rank].allreduce([arg], op="sum").wait(timeout=30)
            if kind == "port":
                assert out.dtype == torch.bfloat16
                return out.view(torch.int16).numpy().view(np.uint16)
            return np.asarray(out).view(np.uint16)

        try:
            with ThreadPoolExecutor(max_workers=2) as pool:
                results[kind] = [f.result(timeout=60) for f in
                                 [pool.submit(worker, r) for r in range(2)]]
        finally:
            for c in cols:
                c.shutdown()
    for rank in range(2):
        np.testing.assert_array_equal(results["port"][rank], results["jax"][rank])


def test_native_abort_latches_sweeps_engine_fds_and_reconfigures(store) -> None:
    """The port's twin of tests/test_ring_engine.py's abort test, on the
    flat ring: rank 2 aborts mid-run, the survivors' next op fails and
    latches (never raises), and the reconfigure to a ring of two closes
    every dup'd fd of the failed engine and every old lane socket, then
    reduces on a fresh native engine."""
    world = 3
    cols = [TCPCollective(timeout=5.0, lanes=2, chunk_bytes=CHUNK, engine="native", host=HOST)
            for _ in range(world)]
    prefix, prefix2 = f"abort/{next(_PREFIX)}", f"abort/{next(_PREFIX)}"
    engines: Dict[int, object] = {}
    old_socks: Dict[int, list] = {}
    barrier = threading.Barrier(world)

    def worker(rank: int) -> str:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, world)
        assert c.ring_engine == "native"
        engines[rank] = c._engine
        assert engines[rank].open_fd_count() == 4  # 2 lanes x 2 directions
        old_socks[rank] = [p.sock for p in c._next_lanes + c._prev_lanes]
        x = np.ones(8192, dtype=np.float32)
        c.allreduce([x]).wait(timeout=20)
        barrier.wait(timeout=10)
        if rank == world - 1:
            c.abort()
            return "dead"
        exc = c.allreduce([x]).exception(timeout=20)
        assert exc is not None, "expected a failure after the peer's abort"
        assert c.errored() is not None
        # Latched: later ops fail at once without touching the dead ring.
        assert c.allreduce([x]).exception(timeout=20) is not None
        return "latched"

    with ThreadPoolExecutor(max_workers=world) as pool:
        states = [f.result(timeout=90) for f in [pool.submit(worker, r) for r in range(world)]]
    assert states.count("latched") == world - 1

    def recover(rank: int) -> np.ndarray:
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix2}", rank, 2)
        assert c.errored() is None
        assert engines[rank].open_fd_count() == 0
        assert all(s.fileno() == -1 for s in old_socks[rank])
        assert c.ring_engine == "native" and c._engine is not engines[rank]
        (out,) = c.allreduce([np.full(4, float(rank + 1), dtype=np.float32)]).wait(timeout=20)
        return out

    try:
        with ThreadPoolExecutor(max_workers=2) as pool:
            for f in [pool.submit(recover, r) for r in range(2)]:
                np.testing.assert_array_equal(f.result(timeout=90), np.full(4, 3.0, np.float32))
    finally:
        for c in cols:
            c.shutdown()
    assert all(e.open_fd_count() == 0 for e in engines.values())


def test_engine_selection_raises_for_native_and_warns_once_for_auto(
        store, monkeypatch, caplog) -> None:
    class Broken:
        TIER_FLAT = 0

        def __init__(self, lanes: int) -> None:
            raise RuntimeError("libtpuft.so lacks tf_ring_new (stale build)")

    monkeypatch.setattr(_native, "RingEngine", Broken)
    monkeypatch.setattr(C, "_native_fallback_warned", False)
    native = [TCPCollective(timeout=10.0, engine="native", host=HOST) for _ in range(2)]
    prefix = f"select/{next(_PREFIX)}"
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = [pool.submit(native[r].configure, f"{store.address()}/{prefix}", r, 2)
                for r in range(2)]
        for f in futs:
            with pytest.raises(RuntimeError, match="engine='native'"):
                f.result(timeout=30)
    for c in native:
        c.shutdown()

    with caplog.at_level(logging.WARNING, logger="torchft_tpu_torch.collectives"):
        for _ in range(2):  # two configurations, one warning
            got = _run_ring(store, [TCPCollective(timeout=10.0, engine="auto", host=HOST)
                                    for _ in range(2)])
            assert {r["engine"] for r in got.values()} == {"py"}
    warnings = [r for r in caplog.records if "PYTHON ring engine" in r.getMessage()]
    assert len(warnings) == 1 and "stale build" in warnings[0].getMessage()


def test_defaults_match_the_jax_flagship_collective(jax_collectives, monkeypatch) -> None:
    """``TCPCollective(timeout, host)`` as the entry points build it takes
    the JAX package's defaults: 2 lanes, 4 MB stripes, the f32 wire, the
    auto engine, which resolves to the native one."""
    for env in ("TPUFT_RING_LANES", "TPUFT_RING_ENGINE", "TPUFT_LINK_PROFILE",
                "TPUFT_SHAPED_LINK"):
        monkeypatch.delenv(env, raising=False)
    port = TCPCollective(timeout=30.0, host=HOST)
    ref = jax_collectives.TCPCollective(timeout=30.0)
    assert (port.lanes, port._chunk_bytes, port.wire_dtype, port._engine_mode) == (
        ref._lanes, ref._chunk_bytes, ref.wire_dtype, ref._engine_mode) == (2, 4 << 20, "f32",
                                                                          "auto")
    assert _native.ring_engine_available()
    for max_chunk in (0, 1, CHUNK, 5 * CHUNK + 1, 300 * CHUNK, 537 << 20):
        for lanes in (1, 2, 3, 4, 6, 8):
            a = TCPCollective(chunk_bytes=CHUNK, lanes=lanes, host=HOST)
            b = jax_collectives.TCPCollective(chunk_bytes=CHUNK, lanes=lanes)
            assert a._stripe_count(max_chunk) == b._stripe_count(max_chunk)
            assert [a._tag_base(s, t) for s in (0, 7, 2**22) for t in (0, 5, 63)] == \
                [b._tag_base(s, t) for s in (0, 7, 2**22) for t in (0, 5, 63)]
    assert port.wire_nbytes(np.zeros(10, np.float32)) == 40
    assert TCPCollective(wire_dtype="bf16").wire_nbytes(torch.zeros(10)) == 20


def test_ring_engine_counters_and_detach(store) -> None:
    """The engine's byte counters see every frame of a pass, and a detach
    with no op in flight releases its dup'd fds without shutting the
    collective's own sockets down."""
    cols = [TCPCollective(timeout=10.0, lanes=2, chunk_bytes=CHUNK, engine="native", host=HOST)
            for _ in range(2)]
    prefix = f"counters/{next(_PREFIX)}"

    def worker(rank: int):
        c = cols[rank]
        c.configure(f"{store.address()}/{prefix}", rank, 2)
        c.allreduce([np.ones(10_000, dtype=np.float32)]).wait(timeout=20)
        engine = c._engine
        assert engine.pass_calls == 1  # one crossing into the engine for all stripes
        sent, recv = engine.counters(_native.RingEngine.TIER_FLAT)
        links = [engine.link_bytes(_native.RingEngine.TIER_FLAT, d, lane)
                 for d in (0, 1) for lane in range(2)]
        return engine, sent, recv, links, c

    with ThreadPoolExecutor(max_workers=2) as pool:
        got = [f.result(timeout=60) for f in [pool.submit(worker, r) for r in range(2)]]
    try:
        for engine, sent, recv, links, c in got:
            # Each rank sends half the payload twice (reduce-scatter and
            # allgather), in stripes with a 12-byte header each.
            assert len(sent) == len(recv) == 2 and sum(sent) >= 40_000 and sum(recv) >= 40_000
            assert links == sent + recv
            engine.detach()
            assert engine.open_fd_count() == 0
            assert all(p.sock.fileno() != -1 for p in c._next_lanes + c._prev_lanes)
    finally:
        for c in cols:
            c.shutdown()


# -- the int8 / int4 wire codecs ---------------------------------------------------


def _codec_inputs() -> List[np.ndarray]:
    """Seeded normals at several scales, an odd length, the non-finite
    values the quantizers special-case, and an all-zero chunk."""
    rng = np.random.default_rng(7)
    out = [(rng.standard_normal(n) * s).astype(np.float32)
           for n, s in ((1, 1.0), (7, 1e-3), (4097, 3.0), (10_000, 1e4))]
    special = rng.standard_normal(64).astype(np.float32)
    special[[3, 17, 40]] = [np.nan, np.inf, -np.inf]
    out += [special, np.array([np.nan, 1.0, -2.0], np.float32),
            np.array([np.inf, 5.0], np.float32), np.zeros(33, np.float32),
            np.array([], np.float32), rng.standard_normal(300)]  # the last one f64
    return out


@pytest.mark.parametrize("which", ["int8", "int4"])
def test_quantizers_and_nibble_packing_bitwise_equal_the_jax_package(jax_collectives,
                                                                     which) -> None:
    port_q = C.quantize_int8 if which == "int8" else C.quantize_int4
    ref_q = (jax_collectives.quantize_int8 if which == "int8"
             else jax_collectives.quantize_int4)
    for x in _codec_inputs():
        with np.errstate(invalid="ignore"):
            s_port, q_port = port_q(x)
            s_ref, q_ref = ref_q(x)
        assert s_port == s_ref and np.float32(s_port) == np.float32(s_ref)
        assert q_port.dtype == q_ref.dtype == np.int8
        np.testing.assert_array_equal(q_port, q_ref)
        packed = C.pack_int4(np.clip(q_port, -7, 7))
        np.testing.assert_array_equal(packed, jax_collectives.pack_int4(np.clip(q_ref, -7, 7)))
        np.testing.assert_array_equal(C.unpack_int4(packed.tobytes(), q_port.size),
                                      jax_collectives.unpack_int4(packed.tobytes(), q_ref.size))
        np.testing.assert_array_equal(C.unpack_int4(packed.tobytes(), q_port.size),
                                      np.clip(q_port, -7, 7))


_CODEC_REFERENCE: Dict[tuple, Dict[int, dict]] = {}


def _all_jax_py_codec(store, lanes: int, codec: str, jax_collectives) -> Dict[int, dict]:
    key = (lanes, codec)
    if key not in _CODEC_REFERENCE:
        _CODEC_REFERENCE[key] = _run_ring(
            store, [_make("jax", "py", lanes, "f32", jax_collectives) for _ in range(2)],
            codec=codec)
    return _CODEC_REFERENCE[key]


@pytest.mark.parametrize("port_rank", [0, 1])
@pytest.mark.parametrize("jax_engine, port_engine",
                         [("py", "py"), ("py", "native"), ("native", "py"), ("native", "native")])
@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_mixed_jax_and_port_ring_codec_bitwise(store, jax_collectives, lanes, codec, jax_engine,
                                               port_engine, port_rank) -> None:
    ref = _all_jax_py_codec(store, lanes, codec, jax_collectives)
    cols = [_make("jax", jax_engine, lanes, "f32", jax_collectives) for _ in range(2)]
    cols[port_rank] = _make("port", port_engine, lanes, "f32", jax_collectives)
    got = _run_ring(store, cols, codec=codec)
    assert got[port_rank]["engine"] == port_engine
    for rank in range(2):
        _assert_bitwise(ref[rank]["out"], got[rank]["out"],
                        f"lanes={lanes} codec={codec} jax={jax_engine} port={port_engine} "
                        f"port_rank={port_rank} rank={rank}")


@pytest.mark.parametrize("world, lanes", [(2, 1), (2, 2), (2, 4), (3, 2)])
@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_port_codec_native_engine_bitwise_equals_python_engine(store, world, lanes,
                                                               codec) -> None:
    outs = {}
    for engine in ("py", "native"):
        got = _run_ring(store, [_make("port", engine, lanes, "bf16", None) for _ in range(world)],
                        codec=codec)
        assert {r["engine"] for r in got.values()} == {engine}
        outs[engine] = got
    for rank in range(world):
        _assert_bitwise(outs["py"][rank]["out"], outs["native"][rank]["out"],
                        f"world={world} lanes={lanes} codec={codec} rank={rank}")
        _assert_bitwise(outs["native"][0]["out"], outs["native"][rank]["out"], f"rank={rank}")
    # The codec supersedes the bf16 wire, and the sums stay near the exact ones.
    exact = [sum(_payloads(r)[0][0].astype(np.float64) for r in range(world))]
    err = np.abs(outs["native"][0]["out"][0] - exact[0])
    tol = (2 ** -6 if codec == "int8" else 0.5) * world * np.abs(exact[0]).max()
    assert err.max() <= tol, (err.max(), tol)


def test_codec_wire_nbytes_contract_and_integer_refusal(jax_collectives) -> None:
    port = TCPCollective(host=HOST)
    ref = jax_collectives.TCPCollective()
    assert tuple(port.wire_codecs) == tuple(ref.wire_codecs) == ("int8", "int4")
    for n in (1, 2, 4097, 1 << 20):
        x = np.zeros(n, np.float32)
        for codec in ("int8", "int4"):
            assert port.wire_nbytes(x, True, codec) == ref.wire_nbytes(x, True, codec)
            assert port.wire_nbytes(torch.from_numpy(x), True, codec) == \
                ref.wire_nbytes(x, True, codec)
        assert port.wire_nbytes(np.zeros(5, np.int32), True, "int8") == 20  # integers: raw
    big = np.zeros(1 << 20, np.float32)
    assert port.wire_nbytes(big, True, "int8") <= 0.27 * big.nbytes
    assert port.wire_nbytes(big, True, "int4") <= 0.13 * big.nbytes
    for bad, match in (([np.arange(4, dtype=np.int64)], "floating"),
                       ([torch.arange(4)], "floating"),
                       ([np.zeros(4, np.float32), np.arange(4, dtype=np.int32)], "floating")):
        exc = port.allreduce(bad, wire_codec="int8").exception(timeout=5)
        assert isinstance(exc, ValueError) and match in str(exc)
    exc = port.allreduce([np.zeros(4, np.float32)], wire_codec="fp8").exception(timeout=5)
    assert isinstance(exc, ValueError) and "unsupported wire_codec" in str(exc)
    assert C.DummyCollective().allreduce([np.ones(2, np.float32)], wire_codec="int4").wait()


@pytest.mark.parametrize("codec", [None, "int8"])
def test_bf16_tensors_off_the_bf16_wire_sum_in_bf16_as_ml_dtypes_arrays(store, jax_collectives,
                                                                        codec) -> None:
    """A bf16 payload on the f32 wire rides raw bf16 frames (or codec
    frames) and sums in bf16 on both packages' engines."""
    import ml_dtypes

    base = [np.linspace(-3, 3, 5001, dtype=np.float32) * (r + 1) + 1e-3 * r for r in range(2)]
    results = {}
    for kind in ("jax", "port"):
        cols = [_make(kind, "native", 2, "f32", jax_collectives) for _ in range(2)]
        prefix = f"bf16acc/{next(_PREFIX)}"

        def worker(rank: int, cols=cols, kind=kind, prefix=prefix) -> np.ndarray:
            cols[rank].configure(f"{store.address()}/{prefix}", rank, 2)
            bits = base[rank].astype(ml_dtypes.bfloat16)
            arg = (bits if kind == "jax"
                   else torch.from_numpy(bits.view(np.uint16).view(np.int16)).view(torch.bfloat16))
            kwargs = {} if codec is None else {"wire_codec": codec}
            (out,) = cols[rank].allreduce([arg], op="avg", **kwargs).wait(timeout=30)
            if kind == "port":
                assert out.dtype == torch.bfloat16
                return out.view(torch.int16).numpy().view(np.uint16)
            return np.asarray(out).view(np.uint16)

        try:
            with ThreadPoolExecutor(max_workers=2) as pool:
                results[kind] = [f.result(timeout=60) for f in
                                 [pool.submit(worker, r) for r in range(2)]]
        finally:
            for c in cols:
                c.shutdown()
    for rank in range(2):
        np.testing.assert_array_equal(results["port"][rank], results["jax"][rank])


# -- incremental reconfiguration ------------------------------------------------


def _fd_count() -> int:
    return len(os.listdir("/proc/self/fd"))


def _settle_fds(target: int, timeout_s: float = 10.0) -> int:
    """tests/test_elastic_churn.py's ``_settle_fds``: closed sockets release
    their fds a beat after shutdown."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        gc.collect()
        n = _fd_count()
        if n <= target:
            return n
        time.sleep(0.1)
    gc.collect()
    return _fd_count()


def _generation(store, members: Dict[int, object], timeout: float = 20.0) -> dict:
    """One quorum change, as tests/test_elastic_churn.py's ``_run_generation``
    runs it: every live member configures onto a fresh prefix (ranked by
    member id) and runs one allreduce of small integers (exact in f32) and
    one bf16 payload.  Asserts every rank holds the same bits and the true
    sum; returns the bits and each member's ``last_configure``."""
    import ml_dtypes

    live = sorted(members)
    world = len(live)
    prefix = f"inc/{next(_PREFIX)}"

    def worker(rank: int):
        c = members[live[rank]]
        c.configure(f"{store.address()}/{prefix}", rank, world)
        xs = [np.arange(96, dtype=np.float32) % 7.0 + float(rank + 1),
              np.full(33, float(rank + 1), dtype=np.dtype(ml_dtypes.bfloat16)),
              np.full(6000, float(rank + 1), dtype=np.float32)]
        res = c.allreduce(xs, op="sum").wait(timeout=timeout)
        lc = c.last_configure
        return (b"".join(np.asarray(r).tobytes() for r in res),
                (lc["mode"], lc["reused_lanes"], lc["opened_lanes"]), float(res[2][0]))

    with ThreadPoolExecutor(max_workers=world) as pool:
        results = [f.result(timeout=timeout + 60)
                   for f in [pool.submit(worker, r) for r in range(world)]]
    assert len({r[0] for r in results}) == 1, f"ranks diverged at world {world}"
    assert results[0][2] == world * (world + 1) / 2
    return {"bits": results[0][0], "cfg": {live[r]: results[r][1] for r in range(world)}}


# The soak's walk (worlds 3 -> 2 -> 3 -> 4 -> 3 -> 2 -> 2 -> 3): leaves, joins,
# a survivor replaced by a fresh incarnation in the same change that admits
# a member, and a world-2 replacement.
_WALK = [("leave", 2), ("join", 3), ("join", 4), ("leave", 0), ("leave", 3),
         ("replace", 1), ("join", 5), ("replace_join", 4)]


def _walk(store, make, seed_members=(0, 1, 2)) -> List[dict]:
    members = {i: make(i) for i in seed_members}
    out = [_generation(store, members)]
    try:
        for kind, who in _WALK:
            if kind == "leave":
                members.pop(who).shutdown()
            elif kind == "join":
                members[who] = make(who)
            elif kind == "replace":
                members.pop(who).shutdown()
                members[who] = make(who)
            else:  # a survivor replaced in the change that admits a member
                members.pop(who).shutdown()
                members[who] = make(who)
                members[who + 10] = make(who + 10)
            out.append(_generation(store, members))
    finally:
        for c in members.values():
            c.shutdown()
    return out


@pytest.mark.parametrize("engine", ["py", "native"])
def test_churn_soak_bitwise_with_reuse_and_no_fd_leak(store, engine) -> None:
    """The port's twin of tests/test_elastic_churn.py's soak on the flat
    ring: every generation is bitwise the same on every rank, the
    incremental path reuses lanes, the full path still runs for fresh
    members, and the walk leaks no fd (the native engine's dup'd ones
    included)."""
    gc.collect()
    fd_before = _fd_count()
    gens = _walk(store, lambda i: TCPCollective(timeout=15.0, lanes=2, chunk_bytes=CHUNK,
                                                engine=engine, host=HOST))
    modes = {m for g in gens for m, _, _ in g["cfg"].values()}
    assert modes == {"incremental", "full"}, modes
    assert sum(r for g in gens for _, r, _ in g["cfg"].values()) > 0
    # 3 -> 2 (member 2 leaves): the 0 -> 1 edge survives on both of its ends.
    assert gens[1]["cfg"][0] == ("incremental", 2, 2)
    assert gens[1]["cfg"][1] == ("incremental", 2, 2)
    fd_after = _settle_fds(fd_before)
    assert fd_after <= fd_before, f"leaked fds: {fd_before} -> {fd_after}"


@pytest.mark.parametrize("engine", ["py", "native"])
def test_incremental_vs_full_bitwise_parity(store, jax_collectives, monkeypatch,
                                            engine) -> None:
    """tests/test_elastic_churn.py's parity matrix: the same walk and payloads
    with ``TPUFT_INCREMENTAL_RECONF`` 1 and 0 give the same bits in every
    generation, and both equal an all-JAX walk on the full path."""
    runs = {}
    for knob in ("1", "0"):
        monkeypatch.setenv("TPUFT_INCREMENTAL_RECONF", knob)
        runs[knob] = _walk(store, lambda i: TCPCollective(
            timeout=15.0, lanes=2, chunk_bytes=CHUNK, engine=engine, host=HOST))
    assert {m for g in runs["0"] for m, _, _ in g["cfg"].values()} == {"full"}
    assert "incremental" in {m for g in runs["1"] for m, _, _ in g["cfg"].values()}
    ref = _walk(store, lambda i: jax_collectives.TCPCollective(
        timeout=15.0, lanes=2, chunk_bytes=CHUNK, topology="ring", engine="py",
        transport="tcp"))
    for gen, (a, b, r) in enumerate(zip(runs["1"], runs["0"], ref)):
        assert a["bits"] == b["bits"] == r["bits"], f"generation {gen} differs"


@pytest.mark.parametrize("engine", ["py", "native"])
def test_world2_neighbor_replacement_no_stall(store, engine) -> None:
    """tests/test_elastic_churn.py's world-2 regression: the survivor's only
    neighbour is replaced, no edge survives, and the survivor stays on the
    incremental path and rebuilds both edges over its kept listener with
    no stall (twice: rebuilt edges must survive a rebuild)."""
    make = lambda: TCPCollective(timeout=15.0, lanes=2, chunk_bytes=CHUNK,  # noqa: E731
                                 engine=engine, host=HOST)
    members = {0: make(), 1: make()}
    try:
        _generation(store, members)
        for _ in range(2):
            members.pop(1).shutdown()
            members[1] = make()
            t0 = time.monotonic()
            gen = _generation(store, members)
            assert time.monotonic() - t0 < 20.0
            assert gen["cfg"][0] == ("incremental", 0, 4), gen["cfg"]
            assert gen["cfg"][1] == ("full", 0, 4), gen["cfg"]
    finally:
        for c in members.values():
            c.shutdown()


@pytest.mark.parametrize("jax_inc, port_inc", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("port_engine", ["py", "native"])
def test_mixed_ring_churn_matches_an_all_jax_ring(store, jax_collectives, jax_inc, port_inc,
                                                  port_engine) -> None:
    """A ring of JAX and port members (even ids JAX, odd ids port) through
    the churn walk, with the incremental knob on or off on each side: every
    generation's bits and every member's (mode, reused_lanes,
    opened_lanes) equal an all-JAX ring's whose members carry the same
    knobs."""

    def make(kind: str, inc: bool, i: int):
        c = _make(kind, "native" if kind == "jax" else port_engine, 2, "f32", jax_collectives,
                  timeout=15.0)
        c._incremental = inc
        return c

    mixed = _walk(store, lambda i: make("jax", jax_inc, i) if i % 2 == 0
                  else make("port", port_inc, i))
    ref = _walk(store, lambda i: make("jax", jax_inc if i % 2 == 0 else port_inc, i))
    for gen, (a, b) in enumerate(zip(mixed, ref)):
        assert a["bits"] == b["bits"], f"generation {gen}: bits differ"
        assert a["cfg"] == b["cfg"], f"generation {gen}: {a['cfg']} != {b['cfg']}"
    assert "incremental" in {m for g in mixed for m, _, _ in g["cfg"].values()}


@pytest.mark.parametrize("engine", ["py", "native"])
def test_a_rank_that_missed_a_quorum_rebuilds_its_edge(store, engine) -> None:
    """Members 0 and 2 form a ring; 0 then forms one with 1 while 2 misses
    that quorum; 0 and 2 meet again.  Both kept their listeners and tokens,
    but 0 closed the old edge when it reconfigured without 2, so neither end
    may reuse it: 2 reads from ``nbrs_<r>`` that 0 last recorded 1, and both
    rebuild the edge over their kept listeners at once (an identity-only
    rule has 2 reuse a dead socket while 0 waits out the rendezvous for its
    dial)."""
    make = lambda: TCPCollective(timeout=15.0, lanes=2, chunk_bytes=CHUNK,  # noqa: E731
                                 engine=engine, host=HOST)
    cols = {i: make() for i in range(3)}
    for c in cols.values():
        c.RENDEZVOUS_TIMEOUT_S = 10.0
    try:
        _generation(store, {0: cols[0], 2: cols[2]})
        _generation(store, {0: cols[0], 1: cols[1]})
        t0 = time.monotonic()
        gen = _generation(store, {0: cols[0], 2: cols[2]})
        assert time.monotonic() - t0 < 5.0
        assert gen["cfg"] == {0: ("incremental", 0, 4), 2: ("incremental", 0, 4)}
        # And the rebuilt edge is reused at the next change that keeps it.
        gen = _generation(store, {0: cols[0], 2: cols[2]})
        assert gen["cfg"] == {0: ("incremental", 4, 0), 2: ("incremental", 4, 0)}
    finally:
        for c in cols.values():
            c.shutdown()
