"""The port's healing plane on the CPU, with real HTTP servers, a real
native lighthouse and real Managers: the twins of the JAX package's
``tests/test_transports.py`` (HTTP cases), ``tests/test_manager.py`` (the
donor list) and ``tests/test_ec.py`` (the Manager's fallback and the kill
drive).

- Transport: the endpoints and their 4xx answers; the chunked single-donor
  receive and the striped 2- and 3-donor receives, each bitwise a
  ``/full`` fetch; a donor dying mid-heal fails its stripes over; all
  donors dead raises; a checksum-corrupt stripe fails over and both donors
  corrupt raise; a snapshot flip between two stripe requests cannot mix
  generations; the serving window; the pacer.
- The header reader refuses a JAX package frame without importing it (in
  a subprocess that imports only the port), and a port healer a mixed
  quorum assigns to a JAX donor latches that error and fails its vote.
- Manager: the donor list reaches the transport and an unreachable donor
  is left out; the backoff paces failed heals; the erasure reconstruction
  heals in the same round when every donor is gone; ``prefer`` never dials
  a donor; three threaded groups, one killed and restarted with its donor
  path broken, converge bitwise through a counted ``ec_reconstruct``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import timedelta
from typing import Any, Dict, List
from unittest.mock import MagicMock

import numpy as np
import pytest
import torch

from torch_port_ref import REPO, cuda_device, import_reference  # noqa: F401 - fixture
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing._rwlock import RWLock
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.serialization import (
    ForeignFrameError,
    flatten_state_dict,
)
from torchft_tpu_torch.collectives import DummyCollective, TCPCollective
from torchft_tpu_torch.ec import ECPlane, ShardStore, encode_stream
from torchft_tpu_torch.manager import Manager

HOST = "127.0.0.1"
T = 10.0


def _state(seed: int = 0) -> Dict[str, Any]:
    """A state of 20 tensors of uneven sizes and four dtypes, a 0-d one,
    and plain values."""
    g = torch.Generator().manual_seed(seed)
    model = {f"w{i}": torch.randn(37 * (i + 1), generator=g) for i in range(14)}
    model["emb"] = torch.randn(64, 33, generator=g).to(torch.bfloat16)
    model["idx"] = torch.randint(0, 9, (5, 3), generator=g)
    model["mask"] = torch.rand(11, generator=g) > 0.5
    model["scale"] = torch.tensor(2.5)
    return {"model": model, "optim": {"lr": 1e-3, "betas": (0.9, 0.99), "step": 7},
            "extra": [torch.arange(9, dtype=torch.float64), None, "tag"]}


def _flat_bytes(state: Any) -> List[bytes]:
    return [b.tobytes() for b in flatten_state_dict(state)[1]]


def _serve(n: int, state: Any, step: int, **kw) -> List[HTTPTransport]:
    ts = [HTTPTransport(timeout=T, host=HOST, **kw) for _ in range(n)]
    for t in ts:
        t.send_checkpoint([1], step=step, state_dict=state, timeout=T)
        assert t.wait_snapshot(T)
    return ts


def _code(url: str) -> int:
    try:
        with urllib.request.urlopen(url, timeout=5.0) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def _shutdown(*ts) -> None:
    for t in ts:
        t.shutdown()


# -- transport ---------------------------------------------------------------------------------


def test_endpoints_and_4xx_while_a_fetch_succeeds() -> None:
    state = {"a": torch.ones(8), "b": torch.zeros(4)}
    t, = _serve(1, state, 5, num_chunks=2)
    rx = HTTPTransport(timeout=T, host=HOST)
    try:
        base = t.metadata()
        garbage = {
            f"{base}/not/a/thing": 404,
            f"{base}/checkpoint/abc/full": 400,
            f"{base}/checkpoint/-3/full": 404,
            f"{base}/checkpoint/9/full": 404,
            f"{base}/checkpoint/5/chunk_99": 404,
            f"{base}/checkpoint/5/chunk_xx": 404,
            f"{base}/checkpoint/5/chunk_0?n=0": 400,
            f"{base}/checkpoint/5/chunk_0?n=zz": 400,
            f"{base}/checkpoint/5/chunk_2?n=2": 404,
            f"{base}/checkpoint/5/nothing": 404,
            f"{base}/ec/have/5": 404,  # no shard store attached
        }
        for url, want in garbage.items():
            assert _code(url) == want, url
        with urllib.request.urlopen(f"{base}/checkpoint/5/metadata", timeout=5.0) as r:
            assert r.read() == b"\x80\x04K\x02."  # pickle.dumps(2)
        stop = threading.Event()

        def hammer() -> None:
            urls = list(garbage)
            i = 0
            while not stop.is_set():
                _code(urls[i % len(urls)])
                i += 1

        th = threading.Thread(target=hammer)
        th.start()
        try:
            got = rx.recv_checkpoint(0, base, step=5, timeout=T)
        finally:
            stop.set()
            th.join(timeout=10)
        assert torch.equal(got["a"], state["a"]) and torch.equal(got["b"], state["b"])
        assert t.served.get("metadata", 0) >= 2 and t.windows_opened == 1
    finally:
        _shutdown(t, rx)


@pytest.mark.parametrize("mode,n_donors", [("chunked", 1), ("striped", 2), ("striped", 3)])
def test_receive_equals_a_full_fetch_bitwise(monkeypatch, mode, n_donors) -> None:
    state = _state(1)
    donors = _serve(n_donors, state, 11, num_chunks=3)
    plain, = _serve(1, state, 11, num_chunks=0)
    rx = HTTPTransport(timeout=T, host=HOST)
    try:
        full = rx.recv_checkpoint(0, plain.metadata(), step=11, timeout=T)
        assert rx.last_fetch["mode"] == "full" and plain.served.get("full") == 1
        monkeypatch.setenv("TPUFT_HTTP_CHUNK_WORKERS", "3")
        urls = [d.metadata() for d in donors]
        got = rx.recv_checkpoint(0, urls if n_donors > 1 else urls[0], step=11, timeout=T)
        assert _flat_bytes(got) == _flat_bytes(full) == _flat_bytes(state)
        assert got["optim"] == state["optim"] and got["extra"][1:] == [None, "tag"]
        lf = rx.last_fetch
        n_tensors = len(flatten_state_dict(state)[1])
        want_stripes = 3 if n_donors == 1 else min(n_tensors, 2 * n_donors)
        assert (lf["mode"], lf["n_donors"], lf["n_stripes"], lf["workers"]) == \
            (mode, n_donors, want_stripes, 3)
        assert lf["crc_verified"] == n_tensors and lf["crc_ms"] >= 0 and lf["failovers"] == 0
        assert sum(lf["by_donor"]) == want_stripes and all(n > 0 for n in lf["by_donor"])
        assert lf["bytes"] == sum(len(b) for b in _flat_bytes(state))
        assert [d.served.get("chunk", 0) for d in donors] == lf["by_donor"]
    finally:
        _shutdown(*donors, plain, rx)


def test_chunk_workers_follow_the_cpu_count_or_the_knob(monkeypatch) -> None:
    state = _state(2)
    d, = _serve(1, state, 3, num_chunks=4)
    rx = HTTPTransport(timeout=T, host=HOST)
    try:
        monkeypatch.setattr(os, "cpu_count", lambda: 1)
        rx.recv_checkpoint(0, d.metadata(), step=3, timeout=T)
        assert rx.last_fetch["mode"] == "full"  # one core: one stream
        monkeypatch.setattr(os, "cpu_count", lambda: 16)
        rx.recv_checkpoint(0, d.metadata(), step=3, timeout=T)
        assert (rx.last_fetch["mode"], rx.last_fetch["workers"]) == ("chunked", 4)
        monkeypatch.setenv("TPUFT_HTTP_CHUNK_WORKERS", "1")
        rx.recv_checkpoint(0, d.metadata(), step=3, timeout=T)
        assert rx.last_fetch["mode"] == "full"
        monkeypatch.setenv("TPUFT_HTTP_CHUNK_WORKERS", "lots")  # ignored
        got = rx.recv_checkpoint(0, d.metadata(), step=3, timeout=T)
        assert rx.last_fetch["workers"] == 4 and _flat_bytes(got) == _flat_bytes(state)
    finally:
        _shutdown(d, rx)


def test_donor_death_mid_heal_fails_over() -> None:
    state = _state(3)
    a, b = _serve(2, state, 7)
    rx = HTTPTransport(timeout=5.0, host=HOST)
    try:
        a_url = a.metadata()
        orig = rx._urlopen
        killed: List[str] = []

        def hooked(url, timeout):
            # Donor A dies when asked for its first stripe (the header is
            # already served).
            if url.startswith(a_url) and "chunk_" in url and not killed:
                killed.append(url)
                a.shutdown()
            return orig(url, timeout)

        rx._urlopen = hooked
        got = rx.recv_checkpoint(0, [a_url, b.metadata()], step=7, timeout=5.0)
        assert killed and _flat_bytes(got) == _flat_bytes(state)
        lf = rx.last_fetch
        assert lf["failovers"] >= 1 and lf["dead"] == [a_url]
        assert lf["by_donor"][1] == lf["n_stripes"] == b.served["chunk"]
    finally:
        _shutdown(a, b, rx)


def test_all_donors_dead_raises() -> None:
    a, b = HTTPTransport(timeout=2.0, host=HOST), HTTPTransport(timeout=2.0, host=HOST)
    dead = [a.metadata(), b.metadata()]
    _shutdown(a, b)
    rx = HTTPTransport(timeout=2.0, host=HOST)
    try:
        with pytest.raises(RuntimeError, match="all 2 donors failed"):
            rx.recv_checkpoint(0, dead, step=1, timeout=2.0)
        with pytest.raises(Exception):
            rx.recv_checkpoint(0, dead[0], step=1, timeout=2.0)
    finally:
        rx.shutdown()


def test_corrupt_stripe_fails_over_and_both_corrupt_raise() -> None:
    state = _state(4)
    bad, good = _serve(2, state, 0)
    rx = HTTPTransport(timeout=T, host=HOST)
    try:
        # The served copy is corrupted after its checksums were stamped.
        for buf in bad._state[1]:
            buf[-1] ^= 0x01
        got = rx.recv_checkpoint(1, [bad.metadata(), good.metadata()], step=0, timeout=T)
        assert _flat_bytes(got) == _flat_bytes(state) and rx.last_fetch["failovers"] >= 1
        good._state[1][2][-1] ^= 0x01
        with pytest.raises(RuntimeError, match="failed on all"):
            rx.recv_checkpoint(1, [bad.metadata(), good.metadata()], step=0, timeout=T)
        with pytest.raises(RuntimeError, match="checksum mismatch"):
            rx.recv_checkpoint(1, bad.metadata(), step=0, timeout=T)  # chunked
        plain, = _serve(1, state, 0, num_chunks=0)
        plain._state[1][0][0] ^= 0x01
        with pytest.raises(IOError, match="checksum mismatch"):
            rx.recv_checkpoint(1, plain.metadata(), step=0, timeout=T)  # /full
        plain.shutdown()
    finally:
        _shutdown(bad, good, rx)


@pytest.mark.parametrize("flip", ["next_step", "same_step_new_state"])
def test_a_snapshot_flip_between_stripes_cannot_mix_generations(monkeypatch, flip) -> None:
    """Stripes are pulled one at a time; between the first and the second
    both donors flip their served snapshot: to the next step (the later
    stripes get 404s) or to new bytes under the same step (the later
    stripes fail their checksums).  The receive raises; it never returns a
    mix of two generations."""
    old, new = _state(5), _state(6)
    donors = _serve(2, old, 5)
    rx = HTTPTransport(timeout=T, host=HOST)
    monkeypatch.setenv("TPUFT_HTTP_CHUNK_WORKERS", "1")
    try:
        orig = rx._urlopen
        chunks: List[str] = []

        def hooked(url, timeout):
            if "chunk_" in url:
                chunks.append(url)
                if len(chunks) == 2:
                    for d in donors:
                        d.send_checkpoint([1], 6 if flip == "next_step" else 5, new, T)
                        assert d.wait_snapshot(T)
            return orig(url, timeout)

        rx._urlopen = hooked
        with pytest.raises(RuntimeError, match="failed on all 2 donors"):
            rx.recv_checkpoint(0, [d.metadata() for d in donors], step=5, timeout=T)
        assert len(chunks) >= 3  # the second stripe was asked of both donors
        if flip == "next_step":
            assert _code(f"{donors[0].metadata()}/checkpoint/5/chunk_0?n=4") == 404
        rx._urlopen = orig
        step = 6 if flip == "next_step" else 5
        got = rx.recv_checkpoint(0, [d.metadata() for d in donors], step=step, timeout=T)
        assert _flat_bytes(got) == _flat_bytes(new)
    finally:
        _shutdown(*donors, rx)


def test_serving_window_blocks_then_serves_and_disallow_closes_it() -> None:
    t, = _serve(1, {"x": torch.ones(2)}, 1)
    rx = HTTPTransport(timeout=T, host=HOST)
    try:
        t.disallow_checkpoint()
        out: Dict[str, Any] = {}

        def fetch() -> None:
            out["got"] = rx.recv_checkpoint(0, t.metadata(), step=1, timeout=T)

        th = threading.Thread(target=fetch)
        th.start()
        time.sleep(0.3)
        assert "got" not in out  # waiting on the closed window
        t.allow_checkpoint(1)
        th.join(timeout=T)
        assert torch.equal(out["got"]["x"], torch.ones(2)) and t.windows_opened == 2
        t.disallow_checkpoint()
        short = HTTPTransport(timeout=0.3, host=HOST)
        short.send_checkpoint([1], step=1, state_dict={"x": torch.ones(2)}, timeout=1.0)
        short.disallow_checkpoint()
        assert _code(f"{short.metadata()}/checkpoint/1/full") == 503
        short.shutdown()
    finally:
        _shutdown(t, rx)


def test_rwlock_basics() -> None:
    lock = RWLock()
    assert lock.r_acquire(timeout=1) and lock.r_acquire(timeout=1)
    assert not lock.w_acquire(timeout=0.05)
    lock.r_release()
    lock.r_release()
    assert lock.w_acquire(timeout=1) and lock.w_locked()
    assert not lock.r_acquire(timeout=0.05)
    lock.w_release()
    with lock.r_lock(timeout=1):
        assert not lock.w_locked()
    lock.w_acquire()
    with pytest.raises(TimeoutError):
        with lock.r_lock(timeout=0.05):
            pass


def test_pacer_shares_one_link_rate_across_stripes(monkeypatch) -> None:
    state = {f"w{i}": torch.zeros(1 << 16) for i in range(8)}  # 2 MiB
    monkeypatch.setenv("TPUFT_HTTP_SHAPED_MBPS", "2")
    d, = _serve(1, state, 2)
    monkeypatch.delenv("TPUFT_HTTP_SHAPED_MBPS")
    rx = HTTPTransport(timeout=T, host=HOST)
    try:
        t0 = time.monotonic()
        rx.recv_checkpoint(0, d.metadata(), step=2, timeout=T)
        paced = time.monotonic() - t0
        assert paced >= 2 * (1 << 20) / 2e6 * 0.9 and rx.last_fetch["mode"] == "chunked"
        d.set_shaped_mbps(0)
        t0 = time.monotonic()
        rx.recv_checkpoint(0, d.metadata(), step=2, timeout=T)
        assert time.monotonic() - t0 < paced
    finally:
        _shutdown(d, rx)


@pytest.mark.gpu
def test_receive_buffers_are_pinned_on_the_card(cuda_device) -> None:
    state = _state(7)
    d, = _serve(1, state, 1)
    rx = HTTPTransport(timeout=T, host=HOST)
    try:
        got = rx.recv_checkpoint(0, d.metadata(), step=1, timeout=T)
        assert got["model"]["w0"].is_pinned() and _flat_bytes(got) == _flat_bytes(state)
    finally:
        _shutdown(d, rx)


# -- foreign frames ----------------------------------------------------------------------------


def test_foreign_frame_is_refused_without_importing_it(tmp_path) -> None:
    ref = import_reference("torchft_tpu.checkpointing.serialization")
    meta, bufs = ref.flatten_state_dict({"w": np.arange(6, dtype=np.float32), "n": 3}, step=4)
    path = tmp_path / "jax_frame.bin"
    with open(path, "wb") as f:
        ref.write_state_dict(meta, bufs, f)
    script = (
        "import sys\n"
        "from torchft_tpu_torch.checkpointing.serialization import ForeignFrameError, "
        "read_state_dict\n"
        f"with open({str(path)!r}, 'rb') as f:\n"
        "    try:\n"
        "        read_state_dict(f)\n"
        "        raise SystemExit('read a foreign frame')\n"
        "    except ForeignFrameError as e:\n"
        "        print('refused:', e)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'torchft_tpu'))\n"
        "print('imported:', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "refused: checkpoint header names torchft_tpu.checkpointing.serialization." \
           "StateDictMeta" in proc.stdout
    assert "imported: []" in proc.stdout


def test_mixed_quorum_port_healer_latches_the_foreign_frame() -> None:
    """A JAX group commits two steps alone; a port group at step 0 then
    joins its quorum and is told to heal from it: the fetch raises
    ForeignFrameError, the Manager latches it, the port group's vote fails,
    and nothing crashes.  The JAX group holds its vote (and so its serving
    window) until the port group's quorum has resolved."""
    ref = {name: import_reference(f"torchft_tpu.{name}")
           for name in ("manager", "collectives", "checkpointing.http_transport")}
    # A lone newcomer waits up to the join timeout for the previous member.
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=1,
                                  join_timeout_ms=5000)
    timeout = timedelta(seconds=20)
    jm = ref["manager"].Manager(
        collective=ref["collectives"].TCPCollective(timeout=20.0),
        load_state_dict=lambda sd: None, state_dict=lambda: {"w": np.arange(64, dtype=np.float32)},
        min_replica_size=1, timeout=timeout, quorum_timeout=timeout, rank=0, world_size=1,
        replica_id="jaxdonor", lighthouse_addr=lh.address(), init_sync=False,
        checkpoint_transport=ref["checkpointing.http_transport"].HTTPTransport(timeout=20.0),
    )
    solo_done, port_asked, healer_done = threading.Event(), threading.Event(), threading.Event()
    seen: Dict[str, Any] = {}

    def jax_group() -> None:
        for _ in range(2):
            jm.start_quorum()
            jm.should_commit()
        solo_done.set()
        port_asked.wait(30)
        jm.start_quorum()
        healer_done.wait(30)
        seen["jax_committed"] = jm.should_commit()

    th = threading.Thread(target=jax_group)
    th.start()
    pm = None
    try:
        assert solo_done.wait(30)
        pm = Manager(
            collective=TCPCollective(timeout=20.0, host=HOST),
            load_state_dict=lambda sd: seen.setdefault("loaded", sd),
            state_dict=lambda: {"w": torch.zeros(64)}, min_replica_size=1, timeout=timeout,
            quorum_timeout=timeout, connect_timeout=timedelta(seconds=5), rank=0,
            world_size=1, replica_id="porthealer", lighthouse_addr=lh.address(),
            store_addr=HOST, manager_bind=f"{HOST}:0", init_sync=False,
            checkpoint_transport=HTTPTransport(timeout=20.0, host=HOST),
        )
        pm.start_quorum()
        time.sleep(0.5)  # the port's quorum request reaches the lighthouse first
        port_asked.set()
        pm.wait_quorum()
        seen["error"] = pm.errored()
        healer_done.set()
        seen["committed"] = pm.should_commit()
    finally:
        port_asked.set()
        healer_done.set()
        th.join(timeout=60)
        if pm is not None:
            pm.shutdown()
        jm.shutdown()
        lh.shutdown()
    assert isinstance(seen["error"], ForeignFrameError), seen["error"]
    assert seen["committed"] is False and "loaded" not in seen
    assert seen["jax_committed"] is True and jm.current_step() == 3


# -- Manager: donors, backoff, erasure fallback ------------------------------------------------


def _stub_manager(lighthouse: str, transport: Any, applied: Dict[str, Any]) -> Manager:
    """A Manager on a real lighthouse whose quorum client the test stubs."""
    m = Manager(
        collective=DummyCollective(), load_state_dict=lambda sd: applied.update(sd),
        state_dict=lambda: applied, min_replica_size=1, rank=0, world_size=1,
        replica_id="healer", lighthouse_addr=lighthouse, store_addr=HOST,
        manager_bind=f"{HOST}:0", checkpoint_transport=transport,
        timeout=timedelta(seconds=T), quorum_timeout=timedelta(seconds=T),
    )
    m._client = MagicMock()
    return m


def _heal_quorum(max_step: int, donors: List[str], participants: List[str]):
    return _native.QuorumResult(
        quorum_id=2, replica_rank=2, replica_world_size=3, store_address="",
        max_step=max_step, max_replica_rank=None, max_world_size=2, heal=True,
        recover_src_replica_rank=0, recover_src_manager_address=donors[0],
        recover_src_replica_ranks=list(range(len(donors))),
        recover_src_manager_addresses=list(donors),
        participant_replica_ranks=list(range(len(participants))),
        participant_manager_addresses=list(participants),
    )


def _donor_state(step: int) -> Dict[str, Any]:
    return {"user": {"default": {"w": torch.full((64,), 2.5),
                                 "b": torch.arange(8, dtype=torch.float32)}},
            "tpuft": {"step": step, "batches_committed": step * 2}}


def _mock_transport() -> MagicMock:
    from torchft_tpu_torch.checkpointing.serialization import unflatten_state_dict

    t = MagicMock()
    t.serves_all_donors = True
    t.metadata.return_value = "http://healer:0"
    t.materialize.side_effect = unflatten_state_dict
    del t.enqueue_snapshot  # the EC feed needs a real snapshotter
    return t


@pytest.fixture
def lighthouse():
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1)
    yield lh.address()
    lh.shutdown()


@pytest.mark.parametrize("dead", [False, True])
def test_manager_stripes_over_the_donor_list_and_skips_an_unreachable_donor(
        lighthouse, dead) -> None:
    transport = _mock_transport()
    transport.recv_checkpoint.return_value = {"user": {}, "tpuft": {"step": 5,
                                                                    "batches_committed": 0}}
    transport.last_fetch = {"bytes": 10, "fetch_s": 0.1, "mode": "striped", "dead": []}
    m = _stub_manager(lighthouse, transport, {})
    metas = {"mgr-1:0": "http://donor-1:0", "mgr-2:0": "http://donor-2:0"}

    def dial(addr: str) -> str:
        if dead and addr == "mgr-1:0":
            raise TimeoutError("connection refused")
        return metas[addr]

    m._dial_peer_transport = dial
    m._client._quorum.return_value = _heal_quorum(5, ["mgr-1:0", "mgr-2:0"], [])
    try:
        m.start_quorum()
        m.wait_quorum()
        assert m.errored() is None
        kwargs = transport.recv_checkpoint.call_args.kwargs
        if dead:
            assert kwargs["metadata"] == "http://donor-2:0" and kwargs["src_rank"] == 1
        else:
            assert kwargs["metadata"] == ["http://donor-1:0", "http://donor-2:0"]
            assert kwargs["src_rank"] == 0
        assert kwargs["step"] == 5 and m.current_step() == 5
    finally:
        m.shutdown()


def test_donor_cap_and_a_dead_donor_set(lighthouse, monkeypatch) -> None:
    monkeypatch.setenv("TPUFT_MAX_HEAL_DONORS", "2")
    transport = _mock_transport()
    transport.recv_checkpoint.return_value = {"user": {}, "tpuft": {"step": 3,
                                                                    "batches_committed": 0}}
    m = _stub_manager(lighthouse, transport, {})
    m._dial_peer_transport = lambda addr: f"http://{addr}"
    m._client._quorum.return_value = _heal_quorum(3, ["a:1", "b:1", "c:1"], [])
    m._client.should_commit.side_effect = lambda rank, step, ok, **kw: ok
    try:
        m.start_quorum()
        m.wait_quorum()
        assert transport.recv_checkpoint.call_args.kwargs["metadata"] == ["http://a:1",
                                                                           "http://b:1"]

        def unreachable(addr: str) -> str:
            raise TimeoutError("refused")

        m._dial_peer_transport = unreachable
        m.should_commit()
        m.start_quorum()
        m.wait_quorum()
        assert "no heal donor reachable" in str(m.errored())
        assert m.should_commit() is False and m._heal_failures == 1
    finally:
        m.shutdown()


def test_backoff_paces_failed_heal_retries(lighthouse, monkeypatch) -> None:
    monkeypatch.setenv("TPUFT_HEAL_BACKOFF_BASE_S", "0.05")
    monkeypatch.setenv("TPUFT_HEAL_BACKOFF_CAP_S", "0.2")
    transport = _mock_transport()
    transport.recv_checkpoint.side_effect = IOError("stripe 0/2 failed: checksum mismatch")
    applied: Dict[str, Any] = {}
    m = _stub_manager(lighthouse, transport, applied)
    m._dial_peer_transport = lambda addr: f"http://{addr}"
    m._client._quorum.return_value = _heal_quorum(4, ["a:1", "b:1"], [])
    m._client.should_commit.side_effect = lambda rank, step, ok, **kw: ok
    delays: List[float] = []
    inner = m._heal_backoff.next
    m._heal_backoff.next = lambda: delays.append(inner()) or delays[-1]
    try:
        for attempt in range(4):
            t0 = time.monotonic()
            m.start_quorum()
            m.wait_quorum()
            took = time.monotonic() - t0
            assert isinstance(m.errored(), IOError)  # latched, not raised
            assert m.should_commit() is False and m._heal_failures == attempt + 1
            assert len(delays) == attempt  # the first fetch is not delayed
            if attempt:
                assert took >= delays[-1] * 0.9
        assert all(0.05 <= d <= 0.2 for d in delays)
        transport.recv_checkpoint.side_effect = None
        transport.recv_checkpoint.return_value = _donor_state(4)
        m.start_quorum()
        m.wait_quorum()
        assert m.errored() is None and m.should_commit() is True
        assert m._heal_failures == 0 and len(delays) == 4 and m.current_step() == 5
        assert torch.equal(applied["w"], torch.full((64,), 2.5))
    finally:
        m.shutdown()


def _holder(step: int, state: Dict[str, Any], k: int = 2, m: int = 1) -> HTTPTransport:
    holder = HTTPTransport(timeout=T, host=HOST)
    store = ShardStore(retain=2)
    holder.attach_shard_store(store)
    for s in encode_stream(*flatten_state_dict(state, step=step), k, m, step=step):
        store.put(s)
    return holder


def test_ec_reconstructs_in_the_same_round_when_every_donor_is_gone(
        lighthouse, monkeypatch, tmp_path) -> None:
    events = tmp_path / "ec.jsonl"
    monkeypatch.setenv("TPUFT_METRICS_PATH", str(events))
    monkeypatch.setenv("TPUFT_EC_K", "2")
    monkeypatch.setenv("TPUFT_EC_M", "1")
    monkeypatch.setenv("TPUFT_HEAL_BACKOFF_BASE_S", "0.01")
    monkeypatch.setenv("TPUFT_HEAL_BACKOFF_CAP_S", "0.05")
    donor_state = _donor_state(5)
    holder = _holder(5, donor_state)
    transport = _mock_transport()
    transport.recv_checkpoint.side_effect = RuntimeError("donor dead")
    applied: Dict[str, Any] = {}
    m = _stub_manager(lighthouse, transport, applied)
    m._dial_peer_transport = lambda addr: f"http://{addr}"
    m._client.should_commit.side_effect = lambda rank, step, ok, **kw: ok
    try:
        assert m._ec is not None
        m._ec._resolve_peer = None  # holder URLs as given
        for attempt in range(3):
            # Donors dead and the only holder empty: latched, vote fails.
            m._client._quorum.return_value = _heal_quorum(5, ["a:1"], ["http://127.0.0.1:9"])
            m._ec._peer_http.clear()
            m._ec.reconstruct_state = _short_reconstruct(m._ec)
            m.start_quorum()
            m.wait_quorum()
            assert m.errored() is not None and m.should_commit() is False
            assert m._heal_failures == attempt + 1
        assert not applied
        m._client._quorum.return_value = _heal_quorum(5, ["a:1"], [holder.metadata(), "x", "y"])
        m.start_quorum()
        m.wait_quorum()
        assert m.errored() is None and m.should_commit() is True
        assert m._heal_failures == 0 and m.current_step() == 6
        assert torch.equal(applied["w"], donor_state["user"]["default"]["w"])
        assert torch.equal(applied["b"], donor_state["user"]["default"]["b"])
    finally:
        m.shutdown()
        holder.shutdown()
    recs = [json.loads(line) for line in events.read_text().splitlines()]
    kinds = [e["event"] for e in recs]
    assert kinds.count("heal_start") == 4
    recon = [e for e in recs if e["event"] == "ec_reconstruct"]
    assert len(recon) == 1 and recon[0]["step"] == 5 and recon[0]["parity_used"] == 0
    assert any(e["event"] == "span" and e["phase"] == "ec_reconstruct" for e in recs)


def _short_reconstruct(plane: ECPlane):
    from torchft_tpu_torch.ec.store import reconstruct

    return lambda step, timeout: reconstruct(plane.holder_urls(), step, timeout=0.5, poll_s=0.1)


def test_prefer_mode_never_dials_a_donor(lighthouse, monkeypatch) -> None:
    monkeypatch.setenv("TPUFT_EC_K", "2")
    monkeypatch.setenv("TPUFT_EC_M", "1")
    monkeypatch.setenv("TPUFT_EC_MODE", "prefer")
    donor_state = _donor_state(7)
    holder = _holder(7, donor_state)
    transport = _mock_transport()
    transport.recv_checkpoint.side_effect = AssertionError("prefer mode dialled a donor")
    applied: Dict[str, Any] = {}
    m = _stub_manager(lighthouse, transport, applied)
    dialled: List[str] = []
    m._dial_peer_transport = lambda addr: dialled.append(addr) or addr
    m._client.should_commit.side_effect = lambda rank, step, ok, **kw: ok
    try:
        assert m._ec is not None and m._ec.config.mode == "prefer"
        m._ec._resolve_peer = None
        m._client._quorum.return_value = _heal_quorum(7, ["donor:1"], [holder.metadata()])
        m.start_quorum()
        m.wait_quorum()
        assert m.errored() is None and m.should_commit() is True
        transport.recv_checkpoint.assert_not_called()
        assert dialled == [] and holder.served.get("full", 0) == 0
        assert torch.equal(applied["w"], donor_state["user"]["default"]["w"])
    finally:
        m.shutdown()
        holder.shutdown()


# -- three threaded groups, one killed -----------------------------------------------------------


KILL_AT, TAIL = 3, 3
# The lighthouse's timeouts, with a margin that a loaded test machine cannot
# eat: a live group's quorum request may lag its peers' by a second or more
# under load, and a join timeout it overran would drop it from the quorum
# (three groups pass the split-brain guard with two), so that it heals
# again or, at the last step, waits alone for peers that have stopped.
HEARTBEAT_MS, JOIN_MS = 5000, 2000
# A step with fewer than three groups pauses this long.  The survivors only
# wait for the restart there, and each step they commit is a generation the
# erasure encoder queues and pushes; at a step every 20 ms a loaded machine
# fell behind by seconds, the shards of the step the restarted group asked
# for were not out within its reconstruct timeout, and the survivors spent
# their 200 steps before it joined.
SHORT_QUORUM_PAUSE_S = 0.2


def _wait_lapsed(lighthouse: "_native.LighthouseServer", replica_id: str,
                 timeout: float) -> None:
    """Waits until the lighthouse counts ``replica_id`` dead: its last
    heartbeat older than HEARTBEAT_MS (``/status.json``)."""
    deadline = time.monotonic() + timeout
    while True:
        status = json.loads(urllib.request.urlopen(
            f"{lighthouse.http_address()}/status.json", timeout=5).read().decode())
        age = status["heartbeat_age_ms"].get(replica_id)
        if age is None or age >= HEARTBEAT_MS:
            return
        assert time.monotonic() < deadline, f"{replica_id} still heartbeats: {age} ms"
        time.sleep(0.05)


def _ft_group(gid: int, incarnation: int, lighthouse: str, shared: dict) -> None:
    """One group: a few tensors trained by the average of per-group
    gradients; incarnation 0 of group 0 stops dead at KILL_AT (its Manager
    and servers shut down under the others); incarnation 1 starts fresh
    with its donor path broken, so only the erasure shards can heal it."""
    params = {"w": torch.zeros(300), "b": torch.zeros(7, dtype=torch.float64)}

    def load(sd):
        for k, v in sd.items():
            params[k].copy_(v)

    transport = HTTPTransport(timeout=30.0, host=HOST)
    if incarnation:
        def broken(*a, **kw):
            shared["broken_fetches"] += 1
            raise RuntimeError("donor set unreachable")

        transport.recv_checkpoint = broken
    m = Manager(
        collective=TCPCollective(timeout=15.0, host=HOST), load_state_dict=load,
        state_dict=lambda: params, min_replica_size=2, rank=0, world_size=1,
        replica_id=f"ec_g{gid}", lighthouse_addr=lighthouse, store_addr=HOST,
        manager_bind=f"{HOST}:0", checkpoint_transport=transport,
        timeout=timedelta(seconds=15), quorum_timeout=timedelta(seconds=30),
        connect_timeout=timedelta(seconds=5), init_sync=False,
    )
    if incarnation:
        inner = m._ec.reconstruct_state

        def counted(step, timeout):
            out = inner(step, timeout)
            shared["reconstructions"].append(step)
            return out

        m._ec.reconstruct_state = counted
    try:
        for _ in range(200):
            target = shared["target"]
            if target is not None and m.current_step() >= target:
                break
            m.start_quorum()
            step = m.current_step()
            g = torch.full((300,), float(gid + 1)) * (step + 1)
            avg = m.allreduce(g).result()
            gb = torch.arange(7, dtype=torch.float64) * (gid - 1)
            avg_b = m.allreduce(gb).result()
            if m.should_commit():
                params["w"].sub_(0.01 * avg)
                params["b"].sub_(0.5 * avg_b)
                if incarnation and shared["target"] is None and m.num_participants() == 3:
                    shared["target"] = m.current_step() + TAIL
            if not incarnation and gid == 0 and m.current_step() == KILL_AT:
                shared["dead_id"] = m.replica_id()
                shared["killed"].set()
                return
            if m.num_participants() < 3:
                time.sleep(SHORT_QUORUM_PAUSE_S)
        shared["final"][gid] = (m.current_step(), {k: v.clone() for k, v in params.items()})
    finally:
        m.shutdown()


def test_three_groups_one_killed_converge_through_ec_reconstruct(monkeypatch) -> None:
    monkeypatch.setenv("TPUFT_EC_K", "2")
    monkeypatch.setenv("TPUFT_EC_M", "1")
    monkeypatch.setenv("TPUFT_HEAL_BACKOFF_BASE_S", "0.05")
    monkeypatch.setenv("TPUFT_HEAL_BACKOFF_CAP_S", "0.2")
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=2,
                                  join_timeout_ms=JOIN_MS, heartbeat_timeout_ms=HEARTBEAT_MS)
    shared = {"target": None, "killed": threading.Event(), "broken_fetches": 0,
              "reconstructions": [], "final": {}}
    errors: List[BaseException] = []

    def run(gid: int, incarnation: int) -> None:
        try:
            _ft_group(gid, incarnation, lh.address(), shared)
        except BaseException as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(g, 0)) for g in range(3)]
    try:
        for t in threads:
            t.start()
        assert shared["killed"].wait(60), "group 0 never reached the kill step"
        threads[0].join(timeout=30)
        _wait_lapsed(lh, shared["dead_id"], timeout=30)
        threads.append(threading.Thread(target=run, args=(0, 1)))
        threads[-1].start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads), "a group hung"
    finally:
        lh.shutdown()
    if errors:
        raise errors[0]
    assert shared["broken_fetches"] >= 1, "the restarted group never tried its donors"
    assert shared["reconstructions"], "no erasure reconstruction happened"
    finals = shared["final"]
    assert sorted(finals) == [0, 1, 2]
    assert len({step for step, _ in finals.values()}) == 1
    for g in (1, 2):
        for k, v in finals[0][1].items():
            assert torch.equal(v, finals[g][1][k]), (g, k)
    assert finals[0][1]["w"].abs().sum() > 0
