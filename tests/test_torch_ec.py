"""The port's erasure-coded state, integrity checksums and heal backoff
against the JAX package's (``torchft_tpu.ec``, ``checkpointing.integrity``,
``ha.backoff``), on inputs made from a numpy seed.

- GF(256): the tables, the pair tables and ``cauchy_matrix`` are equal;
  ``gf_matmul`` and ``gf_mat_inv`` give equal bytes.
- Shards: ``encode_buffers`` on the same stream bytes is bitwise the JAX
  encoder's at (k, m) in {(2, 1), (3, 2), (5, 3)}; every k-subset decodes to
  the identical stream; fewer than k shards raise; a corrupt shard is
  detected on read and excluded by the reconstruction.
- Placement is equal for n in 2..7 and steps 0..20; the shard store keeps
  its retention and reports its coverage; ``ECConfig`` parses and checks
  the environment as the JAX one.
- ``DecorrelatedBackoff`` gives the same delays under one seed; checksums
  are equal under both algorithms.
- The ECPlane write path on real transports: each group keeps its placed
  shards, the step's pusher delivers parity, and the pair reconstructs.
"""

from __future__ import annotations

import io
import itertools
import random
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch.checkpointing import integrity
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.serialization import (
    flatten_state_dict,
    state_dict_frames,
    unflatten_state_dict,
)
from torchft_tpu_torch.ec import encoder, gf, placement
from torchft_tpu_torch.ec.store import (
    ECConfig,
    ECPlane,
    ShardStore,
    fetch_inventory,
    fetch_shard,
    push_shard,
    reconstruct,
)
from torchft_tpu_torch.ha.backoff import DecorrelatedBackoff

HOST = "127.0.0.1"
GEOMETRIES = [(2, 1), (3, 2), (5, 3)]


@pytest.fixture(scope="module")
def ref():
    return {name: import_reference(f"torchft_tpu.{name}")
            for name in ("ec.gf", "ec.encoder", "ec.placement", "ec.store",
                         "checkpointing.integrity", "ha.backoff")}


def _stream(seed: int):
    """A prefix and buffers of odd sizes (padding and shard-boundary
    crossings), as uint8 numpy arrays."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, 256, 61, dtype=np.uint8).tobytes()
    sizes = [997 * 4, 13 * 7 * 8, 8, 0, 4099]
    return prefix, [rng.integers(0, 256, n, dtype=np.uint8) for n in sizes]


def _state(n: int = 6, per: int = 500):
    return {f"layer_{i}": torch.full((per,), float(i) + 0.25) for i in range(n)}


# -- GF(256) -----------------------------------------------------------------------------------


def test_gf_tables_and_cauchy_matrix_equal_the_jax_ones(ref) -> None:
    jgf = ref["ec.gf"]
    assert np.array_equal(gf._EXP, jgf._EXP) and np.array_equal(gf._LOG, jgf._LOG)
    assert np.array_equal(gf._MUL, jgf._MUL)
    for c in (2, 3, 29, 255):
        assert np.array_equal(gf._pair_table(c), jgf._pair_table(c))
    for m, k in [(1, 2), (2, 3), (3, 5), (4, 8)]:
        assert np.array_equal(gf.cauchy_matrix(m, k), jgf.cauchy_matrix(m, k))
    rng = np.random.default_rng(3)
    shards = [rng.integers(0, 256, 1000, dtype=np.uint8) for _ in range(4)]
    mat = gf.cauchy_matrix(3, 4)
    for mine, theirs in zip(gf.gf_matmul(mat, shards), jgf.gf_matmul(mat, shards)):
        assert mine.tobytes() == theirs.tobytes()
    sub = np.vstack([np.eye(4, dtype=np.uint8), mat])[[1, 4, 5, 6]]
    assert np.array_equal(gf.gf_mat_inv(sub), jgf.gf_mat_inv(sub))
    with pytest.raises(ValueError, match="exceeds"):
        gf.cauchy_matrix(200, 100)


# -- shards ------------------------------------------------------------------------------------


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_shards_bitwise_equal_the_jax_encoder(ref, k, m) -> None:
    jenc = ref["ec.encoder"]
    prefix, bufs = _stream(10 * k + m)
    data, total = encoder._gather_stream(prefix, bufs, k)
    jdata, jtotal = jenc._gather_stream(prefix, bufs, k)
    assert total == jtotal
    assert all(a.tobytes() == b.tobytes() for a, b in zip(data, jdata))
    mine = encoder.encode_buffers(data, k, m, step=9, total_len=total, digest=77)
    theirs = jenc.encode_buffers(jdata, k, m, step=9, total_len=total, digest=77)
    assert sorted(mine) == sorted(theirs) == list(range(k + m))
    for i in range(k + m):
        assert mine[i].payload.tobytes() == theirs[i].payload.tobytes(), i
        assert mine[i].header() == theirs[i].header()
        assert encoder.write_shard(mine[i]) == jenc.write_shard(theirs[i])
    # Only the wanted shards, and the same ones.
    want = [0, k + m - 1]
    part = encoder.encode_buffers(data, k, m, 9, total, want=want)
    assert sorted(part) == want and part[k + m - 1].payload.tobytes() == \
        mine[k + m - 1].payload.tobytes()


def test_stream_digest_equals_the_jax_one(ref) -> None:
    jenc = ref["ec.encoder"]
    prefix, bufs = _stream(5)
    for crcs in (None, (1, 2)):
        meta = SimpleNamespace(crcs=crcs)
        assert encoder._stream_digest(meta, bufs, prefix) == jenc._stream_digest(meta, bufs, prefix)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_every_k_subset_decodes_the_identical_stream(k, m) -> None:
    meta, bufs = flatten_state_dict({"a": torch.arange(997, dtype=torch.float32),
                                     "b": torch.full((13, 7), -1.5, dtype=torch.float64),
                                     "count": torch.tensor(41)}, step=9)
    prefix, _ = state_dict_frames(meta, bufs)
    orig = prefix + b"".join(b.tobytes() for b in bufs)
    shards = encoder.encode_stream(meta, bufs, k, m, step=9)
    assert len(shards) == k + m
    for subset in itertools.combinations(range(k + m), k):
        raw = encoder.decode_shards({i: shards[i].payload for i in subset}, k, m,
                                    shards[0].total_len)
        assert raw == orig, subset
        meta2, bufs2 = encoder.decode_stream([shards[i] for i in subset])
        assert [bytes(b) for b in bufs2] == [b.tobytes() for b in bufs]
    out = unflatten_state_dict(meta2, bufs2)
    assert torch.equal(out["a"], torch.arange(997, dtype=torch.float32)) and int(out["count"]) == 41


def test_decode_below_k_raises() -> None:
    meta, bufs = flatten_state_dict(_state(2), step=1)
    shards = encoder.encode_stream(meta, bufs, 3, 2, step=1)
    with pytest.raises(ValueError, match="need 3 shards"):
        encoder.decode_shards({0: shards[0].payload, 4: shards[4].payload}, 3, 2,
                              shards[0].total_len)
    with pytest.raises(ValueError, match="mixed encode generations"):
        divergent = {k: v + 1.0 for k, v in _state(2).items()}
        other = encoder.encode_stream(*flatten_state_dict(divergent, step=1), 3, 2, step=1)
        encoder.decode_stream([shards[0], shards[1], other[2]])


def test_corrupt_shard_is_detected_and_excluded() -> None:
    meta, bufs = flatten_state_dict(_state(5), step=4)
    shards = encoder.encode_stream(meta, bufs, 3, 2, step=4)
    frame = encoder.write_shard(shards[3])
    back = encoder.read_shard(frame)
    assert back.idx == 3 and back.payload.tobytes() == shards[3].payload.tobytes()
    torn = bytearray(frame)
    torn[-1] ^= 0xFF
    with pytest.raises(IOError, match="checksum mismatch"):
        encoder.read_shard(bytes(torn))
    # A stored data shard corrupted in place: the reconstruction excludes
    # it and decodes through parity.
    store = ShardStore(retain=2)
    holder = HTTPTransport(timeout=10.0, host=HOST)
    holder.attach_shard_store(store)
    try:
        for s in shards:
            store.put(s)
        store.get(4, 1).payload[10] ^= 0xFF
        meta2, bufs2, stats = reconstruct([holder.metadata()], 4, timeout=10.0)
        assert [bytes(b) for b in bufs2] == [b.tobytes() for b in bufs]
        assert stats["corrupt"] == 1 and stats["parity_used"] >= 1
        assert 1 not in stats["shards_used"]
    finally:
        holder.shutdown()


def test_reconstruct_times_out_below_k() -> None:
    store = ShardStore(retain=2)
    holder = HTTPTransport(timeout=10.0, host=HOST)
    holder.attach_shard_store(store)
    try:
        shards = encoder.encode_stream(*flatten_state_dict(_state(2), step=3), 3, 1, step=3)
        store.put(shards[0])
        store.put(shards[1])
        with pytest.raises(RuntimeError, match="timed out"):
            reconstruct([holder.metadata()], 3, timeout=1.0, poll_s=0.1)
    finally:
        holder.shutdown()


# -- placement, store, config ------------------------------------------------------------------


@pytest.mark.parametrize("n", range(2, 8))
def test_placement_equals_the_jax_one(ref, n) -> None:
    jpl = ref["ec.placement"]
    holders = list(range(n))
    for step in range(21):
        for n_shards in (3, 5, 8):
            for idx in range(n_shards):
                assert placement.shard_holder(step, idx, holders) == \
                    jpl.shard_holder(step, idx, holders)
            for h in holders:
                assert placement.shards_for_holder(step, h, holders, n_shards) == \
                    jpl.shards_for_holder(step, h, holders, n_shards)
    with pytest.raises(ValueError):
        placement.shard_holder(0, 0, [])


def test_shard_store_retention_and_coverage() -> None:
    st = ShardStore(retain=2)
    assert st.coverage() == (-1, 0) and st.latest_step() == -1
    meta, bufs = flatten_state_dict(_state(2), step=0)
    for step in (1, 2, 3):
        for s in encoder.encode_stream(meta, bufs, 2, 1, step=step):
            st.put(s)
    assert st.have(1) == []
    assert st.have(2) == [0, 1, 2] and st.have(3) == [0, 1, 2]
    assert st.coverage() == (3, 3) and st.latest_step() == 3
    inv = st.inventory(3)
    assert inv["k"] == 2 and inv["m"] == 1 and inv["shards"] == [0, 1, 2]
    assert len(set(inv["digests"].values())) == 1
    assert st.inventory(99)["shards"] == []
    assert st.nbytes() == 2 * 3 * st.get(3, 0).nbytes


def test_ec_config_env_parsing_and_validation(ref, monkeypatch) -> None:
    jstore = ref["ec.store"]
    monkeypatch.setenv("TPUFT_EC_K", "4")
    monkeypatch.setenv("TPUFT_EC_M", "3")
    monkeypatch.setenv("TPUFT_EC_MODE", "prefer")
    monkeypatch.setenv("TPUFT_EC_RETAIN", "0")
    monkeypatch.setenv("TPUFT_EC_INTERVAL", "junk")
    cfg, jcfg = ECConfig.from_env(), jstore.ECConfig.from_env()
    assert (cfg.k, cfg.m, cfg.mode, cfg.retain, cfg.interval) == (4, 3, "prefer", 1, 1)
    assert (jcfg.k, jcfg.m, jcfg.mode, jcfg.retain, jcfg.interval) == (4, 3, "prefer", 1, 1)
    assert cfg.enabled and cfg.n_shards == 7
    monkeypatch.setenv("TPUFT_EC_MODE", "sometimes")
    for cls in (ECConfig, jstore.ECConfig):
        with pytest.raises(ValueError, match="TPUFT_EC_MODE"):
            cls.from_env()
    monkeypatch.delenv("TPUFT_EC_MODE")
    monkeypatch.setenv("TPUFT_EC_K", "0")
    assert not ECConfig.from_env().enabled
    with pytest.raises(ValueError, match="geometry"):
        ECConfig(k=200, m=100)


# -- backoff, checksums ------------------------------------------------------------------------


def test_decorrelated_backoff_equals_the_jax_sequence(ref) -> None:
    jb = ref["ha.backoff"]
    for base, cap, seed in [(0.2, 5.0, 0), (0.05, 2.0, 7), (1.0, 1.0, 3)]:
        mine = DecorrelatedBackoff(base, cap, rng=random.Random(seed))
        theirs = jb.DecorrelatedBackoff(base, cap, rng=random.Random(seed))
        seq = [mine.next() for _ in range(40)]
        assert seq == [theirs.next() for _ in range(40)]
        assert all(base <= d <= max(cap, base) for d in seq)
        mine.reset()
        theirs.reset()
        assert mine.next() == theirs.next()
    with pytest.raises(ValueError):
        DecorrelatedBackoff(0.0)


@pytest.mark.parametrize("algo", ["crc32", "crc32c"])
def test_checksums_equal_the_jax_ones(ref, algo) -> None:
    jint = ref["checkpointing.integrity"]
    if algo == "crc32c" and integrity.CRC_ALGO != "crc32c":
        # Without google_crc32c both modules compute zlib's CRC under the tag.
        assert integrity._ALGOS["crc32c"](b"x") == jint._ALGOS["crc32c"](b"x")
    rng = np.random.default_rng(11)
    for n in (0, 1, 7, 4096, 100_003):
        data = rng.integers(0, 256, n, dtype=np.uint8)
        mine = integrity.checksum(data, algo)
        assert mine == jint.checksum(data, algo) == integrity.checksum(data.tobytes(), algo)
        integrity.verify(memoryview(data), mine, algo, "buf")
        if n:
            bad = data.copy()
            bad[n // 2] ^= 1
            with pytest.raises(IOError, match="checksum mismatch"):
                integrity.verify(bad, mine, algo, "buf")
    assert integrity.CRC_ALGO == jint.CRC_ALGO
    bufs = [rng.integers(0, 256, 333, dtype=np.uint8) for _ in range(3)]
    assert integrity.checksum_buffers(bufs) == jint.checksum_buffers(bufs)
    with pytest.raises(IOError, match="unknown checksum"):
        integrity.verify(b"x", 0, "md5", "buf")


# -- the write path on real transports ---------------------------------------------------------


def test_shard_endpoints_round_trip_and_refuse_a_torn_push() -> None:
    store = ShardStore(retain=2)
    holder = HTTPTransport(timeout=10.0, host=HOST)
    holder.attach_shard_store(store)
    try:
        shards = encoder.encode_stream(*flatten_state_dict(_state(4), step=5), 3, 1, step=5)
        store.put(shards[0])
        push_shard(holder.metadata(), shards[3], 5.0)
        assert fetch_inventory(holder.metadata(), 5, 5.0)["shards"] == [0, 3]
        assert fetch_shard(holder.metadata(), 5, 3, 5.0).payload.tobytes() == \
            shards[3].payload.tobytes()
        frame = bytearray(encoder.write_shard(shards[1]))
        frame[-1] ^= 0xFF
        req = urllib.request.Request(f"{holder.metadata()}/ec/shard/5/1", data=bytes(frame),
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=5.0)
        assert exc.value.code == 400 and store.have(5) == [0, 3]
        for path in ("/ec/shard/5/7", "/ec/shard/x/1", "/ec/nope/5", "/ec/shard/5/0?part=3&n=2"):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(f"{holder.metadata()}{path}", timeout=5.0)
            assert exc.value.code in (400, 404), path
        assert holder.served.get("ec_push") == 1
    finally:
        holder.shutdown()


def test_ec_plane_encodes_on_snapshot_and_pushes_parity() -> None:
    cfg = ECConfig(k=2, m=2)
    ts = [HTTPTransport(timeout=10.0, host=HOST) for _ in range(2)]
    planes = [ECPlane(cfg) for _ in range(2)]
    try:
        addrs = [t.metadata() for t in ts]
        for rank, (t, p) in enumerate(zip(ts, planes)):
            t.attach_shard_store(p.store)
            t.set_snapshot_hook(p.on_snapshot)
            p.set_peers([0, 1], addrs, rank)
        state, step = _state(4), 3
        assert planes[0].wants_snapshot(step) and not planes[0].wants_snapshot(0)
        for t in ts:
            t.enqueue_snapshot(step, state, serve=False)
        assert ts[0].wait_snapshot(10.0) and ts[1].wait_snapshot(10.0)
        assert ts[0]._state is None  # a non-serving snapshot never flips the served slot
        for rank, p in enumerate(planes):
            assert set(p.store.have(step)) >= set(
                placement.shards_for_holder(step, rank, [0, 1], cfg.n_shards))
        assert set(planes[0].store.have(step)) | set(planes[1].store.have(step)) == {0, 1, 2, 3}
        meta, bufs = flatten_state_dict(state, step=step)
        _, bufs2, _ = reconstruct(addrs, step, timeout=10.0)
        assert [bytes(b) for b in bufs2] == [b.tobytes() for b in bufs]
        # A membership change re-places the newest generation.
        t2 = HTTPTransport(timeout=10.0, host=HOST)
        p2 = ECPlane(cfg)
        t2.attach_shard_store(p2.store)
        try:
            ranks = [0, 1, 2]
            planes[0].set_peers(ranks, addrs + [t2.metadata()], 0)
            held = planes[0].store.have(step)
            pushed = planes[0].reshard()
            holders = {i: placement.shard_holder(step, i, ranks) for i in held}
            assert pushed == sum(h != 0 for h in holders.values())
            assert p2.store.have(step) == [i for i, h in holders.items() if h == 2]
        finally:
            t2.shutdown()
        assert planes[0].coverage()[0] == step
    finally:
        for t in ts:
            t.shutdown()


def test_slice_stream_reads_the_virtual_concatenation() -> None:
    slices = [np.arange(6, dtype=np.uint8), np.arange(6, 12, dtype=np.uint8)]
    s = encoder._SliceStream(slices, 10)
    assert s.read(4) == bytes(range(4)) and s.read() == bytes(range(4, 10)) and s.read() == b""
    out = io.BytesIO(encoder._SliceStream(slices, 12).read())
    assert out.getvalue() == bytes(range(12))


@pytest.mark.parametrize("subset", [False, True])
def test_reconstruct_range_striped_and_subset_striped(monkeypatch, subset) -> None:
    """Shards fetched as payload ranges (``TPUFT_EC_FETCH_PARTS``), over
    two holders; with ``TPUFT_EC_SUBSET_STRIPE`` each range decodes from
    its own k-subset, parity included: the same bytes either way."""
    monkeypatch.setenv("TPUFT_EC_FETCH_PARTS", "3")
    monkeypatch.setenv("TPUFT_EC_SUBSET_STRIPE", "1" if subset else "0")
    meta, bufs = flatten_state_dict(_state(5), step=6)
    shards = encoder.encode_stream(meta, bufs, 2, 1, step=6)
    holders = [HTTPTransport(timeout=10.0, host=HOST) for _ in range(2)]
    try:
        for i, h in enumerate(holders):
            store = ShardStore(retain=2)
            h.attach_shard_store(store)
            for s in shards:
                if s.idx % 2 == i or s.idx == 2:
                    store.put(s)
        _, bufs2, stats = reconstruct([h.metadata() for h in holders], 6, timeout=10.0)
        assert [bytes(b) for b in bufs2] == [b.tobytes() for b in bufs]
        if subset:
            assert stats["subset_striped"]["ranges"] == 3 and stats["parity_used"] == 1
        else:
            assert stats["striped_fetches"] == 2 and stats["shards_used"] == [0, 1]
    finally:
        for h in holders:
            h.shutdown()
