"""The port's HA lighthouse (torchft_tpu_torch/ha and the native role
calls) against the JAX package's ``tests/test_ha.py`` contract.

The lease protocol at its boundaries and across packages (a record the port
writes reads in the JAX ``FileLease`` and the reverse), the split-brain
guard on the raw wire (a standby answers Quorum and Heartbeat with a
redirect, HTTP with a 307), the serve-time guard, the failover client
(redirects, a dead address, an error naming every address), replication
with epoch fencing, the two-replica takeover with its ``lighthouse_failover``
event, mixed takeovers on one lease file (a JAX replica over a port one and
the reverse), the CLI as processes, and the repair of the Launcher's evict
and drain and the Manager's drain notice, which now reach the new leader
through an address list.
"""

from __future__ import annotations

import json
import os
import random
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from datetime import timedelta

import pytest

from torch_port_ref import REPO, import_reference
from torchft_tpu_torch import _native, _wire
from torchft_tpu_torch.ha import DecorrelatedBackoff, FileLease, LeaseRecord

# docs/wire.md frame header.
HEADER = struct.Struct("<IHHQQIBBH")
MAGIC = 0x7F7A55AA
OK, UNAVAILABLE = 0, 14
HOST = "127.0.0.1"


def _dial(address: str) -> socket.socket:
    host, _, port = address.rpartition(":")
    return socket.create_connection((host.strip("[]"), int(port)), timeout=10)


def _call(address: str, method: int, payload: bytes, deadline_ms: int = 5000):
    sock = _dial(address)
    try:
        sock.sendall(HEADER.pack(MAGIC, method, 0, 1, deadline_ms, len(payload), 1, 0, 0)
                     + payload)
        raw = b""
        while len(raw) < HEADER.size:
            chunk = sock.recv(HEADER.size - len(raw))
            assert chunk, "server closed mid-header"
            raw += chunk
        _magic, _m, status, _rid, _dl, length, _v, _f, _r = HEADER.unpack(raw)
        body = b""
        while len(body) < length:
            chunk = sock.recv(length - len(body))
            assert chunk, "server closed mid-payload"
            body += chunk
        return status, body
    finally:
        sock.close()


# Sockets bound and never listening: a connect to one is refused, and no
# other process can take its port for the module's life (a port closed
# after the bind went to another test's lighthouse under the parallel run,
# and a Manager meant to fail against it started and heartbeat on).
_DEAD_SOCKETS: list = []


def _dead_address() -> str:
    s = socket.socket()
    s.bind((HOST, 0))
    _DEAD_SOCKETS.append(s)
    return f"{HOST}:{s.getsockname()[1]}"


def _wait(cond, timeout: float = 15.0, what: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _metrics(http: str) -> str:
    return urllib.request.urlopen(f"{http}/metrics", timeout=5).read().decode()


def _quorum_payload(replica_id: str) -> bytes:
    return _wire.encode("LighthouseQuorumRequest", {"requester": {
        "replica_id": replica_id, "address": f"{HOST}:1", "store_address": f"{HOST}:2",
        "world_size": 1}})


@pytest.fixture()
def lighthouse():
    s = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1, join_timeout_ms=500,
                                 http_bind=f"{HOST}:0")
    yield s
    s.shutdown()


# -- backoff ------------------------------------------------------------------------


def test_backoff_bounds_and_decorrelation() -> None:
    b = DecorrelatedBackoff(base_s=0.05, cap_s=2.0, rng=random.Random(7))
    prev, seen = 0.05, []
    for _ in range(200):
        s = b.next()
        assert 0.05 <= s <= min(2.0, 3.0 * prev) + 1e-9
        seen.append(s)
        prev = max(0.05, s)
    assert any(y < x for x, y in zip(seen, seen[1:]))
    assert any(y > x for x, y in zip(seen, seen[1:]))
    b.reset()
    assert b.next() <= 3.0 * 0.05
    with pytest.raises(ValueError):
        DecorrelatedBackoff(base_s=0.0)


# -- the lease ------------------------------------------------------------------------


class _FakeClock:
    def __init__(self, t0: float = 1000.0) -> None:
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def _lease(tmp_path, owner: str, clock, lease_ms: int = 1000, cls=FileLease):
    return cls(str(tmp_path / "lease"), lease_ms, owner, clock=clock, sleep=lambda s: None,
               settle_s=0.0, rng=random.Random(0))


def test_lease_acquire_and_renew_before_expiry_keeps_leadership(tmp_path) -> None:
    clock = _FakeClock()
    a = _lease(tmp_path, "a", clock)
    rec = a.try_acquire("a:1", "http://a:2")
    assert rec is not None and rec.epoch == 1 and rec.owner == "a"
    clock.advance(0.999)
    renewed = a.renew(rec)
    assert renewed is not None and renewed.epoch == 1
    assert renewed.expires_ms == int(clock() * 1000) + 1000
    assert _lease(tmp_path, "b", clock).try_acquire("b:1", "http://b:2") is None


def test_lease_expired_renewal_demotes(tmp_path) -> None:
    clock = _FakeClock()
    a = _lease(tmp_path, "a", clock)
    rec = a.try_acquire("a:1", "http://a:2")
    clock.advance(1.0)
    assert a.renew(rec) is None
    rec_b = _lease(tmp_path, "b", clock).try_acquire("b:1", "http://b:2")
    assert rec_b is not None and rec_b.epoch == 2 and rec_b.owner == "b"
    assert a.renew(rec) is None


def test_lease_release_hands_over_immediately(tmp_path) -> None:
    clock = _FakeClock()
    a = _lease(tmp_path, "a", clock)
    a.release(a.try_acquire("a:1", "http://a:2"))
    rec_b = _lease(tmp_path, "b", clock).try_acquire("b:1", "http://b:2")
    assert rec_b is not None and rec_b.epoch == 2


def test_lease_corrupt_file_reads_as_no_lease(tmp_path) -> None:
    clock = _FakeClock()
    a = _lease(tmp_path, "a", clock)
    (tmp_path / "lease").write_text("garbage\nnot-a-lease\n")
    assert a.read() is None
    (tmp_path / "lease").write_text("x\ny\nz\nw\nv\n")
    assert a.read() is None
    assert a.try_acquire("a:1", "http://a:2") is not None


def test_lease_race_converges_on_exactly_one_leader(tmp_path) -> None:
    path = str(tmp_path / "lease")
    for trial in range(5):
        if os.path.exists(path):
            os.remove(path)
        leases = [FileLease(path, 500, f"cand{i}", settle_s=0.05,
                            rng=random.Random(trial * 3 + i)) for i in range(3)]
        results: list = [None] * 3
        barrier = threading.Barrier(3)

        def race(i: int) -> None:
            barrier.wait()
            results[i] = leases[i].try_acquire(f"cand{i}:1", f"http://cand{i}:2")

        threads = [threading.Thread(target=race, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        winners = [r for r in results if r is not None]
        assert len(winners) == 1, f"trial {trial}: {len(winners)} leaders"
        final = leases[0].read()
        assert final is not None and final.owner == winners[0].owner


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lease_record_is_shared_with_the_jax_package(tmp_path, writer) -> None:
    """A record either package writes reads the same in the other, and the
    other follows it: a live lease blocks it, an expired one it takes at
    the next epoch."""
    jax_lease = import_reference("torchft_tpu.ha.lease")
    clock = _FakeClock()
    cls_w, cls_r = ((FileLease, jax_lease.FileLease) if writer == "port"
                    else (jax_lease.FileLease, FileLease))
    w = _lease(tmp_path, "w:1", clock, cls=cls_w)
    r = _lease(tmp_path, "r:1", clock, cls=cls_r)
    held = w.try_acquire("w:1", "http://w:2")
    seen = r.read()
    assert (seen.epoch, seen.owner, seen.rpc_address, seen.http_address, seen.expires_ms) == (
        held.epoch, held.owner, held.rpc_address, held.http_address, held.expires_ms)
    assert r.try_acquire("r:1", "http://r:2") is None
    clock.advance(1.0)
    took = r.try_acquire("r:1", "http://r:2")
    assert took is not None and took.epoch == 2
    assert w.renew(held) is None
    assert vars(w.read()) == vars(LeaseRecord(2, "r:1", "r:1", "http://r:2", took.expires_ms))


# -- the native server's role --------------------------------------------------------


def test_standby_quorum_and_heartbeat_redirect_not_serve(lighthouse) -> None:
    lighthouse.set_role(False, "10.0.0.9:29510", "http://10.0.0.9:29511", 4, 0)
    status, body = _call(lighthouse.address(), _native.LIGHTHOUSE_QUORUM,
                         _quorum_payload("g0:x"), 3000)
    assert status == UNAVAILABLE
    text = body.decode()
    assert text.startswith(_native.NOT_LEADER_PREFIX)
    assert "leader=10.0.0.9:29510" in text and "epoch=4" in text
    assert _native.parse_not_leader(text) == "10.0.0.9:29510"
    hb = _wire.encode("LighthouseHeartbeatRequest", {"replica_id": "g0:x"})
    status, body = _call(lighthouse.address(), _native.LIGHTHOUSE_HEARTBEAT, hb)
    assert status == UNAVAILABLE and body.decode().startswith("not the leader")
    assert _native.parse_not_leader("not the leader; leader= http= epoch=0") == ""
    assert _native.parse_not_leader("is draining") is None


def test_expired_lease_leader_stops_serving(lighthouse) -> None:
    now_ms = int(time.time() * 1000)
    lighthouse.set_role(True, lighthouse.address(), lighthouse.http_address(), 2, now_ms + 600)
    assert lighthouse.role() == 1 and lighthouse.leader_epoch() == 2
    status, _ = _call(lighthouse.address(), _native.LIGHTHOUSE_QUORUM,
                      _quorum_payload("g0:a"), 3000)
    assert status == OK
    time.sleep(0.7)
    assert lighthouse.role() == 0
    status, body = _call(lighthouse.address(), _native.LIGHTHOUSE_QUORUM,
                         _quorum_payload("g0:a"), 2000)
    assert status == UNAVAILABLE
    text = body.decode()
    assert "leader= http=" in text and lighthouse.address() not in text


def test_blocked_quorum_join_unblocks_on_demotion() -> None:
    big = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=2, join_timeout_ms=30000,
                                   http_bind=f"{HOST}:0")
    try:
        t0 = time.time()
        result: dict = {}

        def join() -> None:
            result["status"], result["body"] = _call(
                big.address(), _native.LIGHTHOUSE_QUORUM, _quorum_payload("g0:a"), 20000)

        t = threading.Thread(target=join)
        t.start()
        time.sleep(0.5)
        big.set_role(False, "10.0.0.9:29510", "", 9, 0)
        t.join(timeout=10.0)
        assert not t.is_alive(), "the blocked join did not end on demotion"
        assert result["status"] == UNAVAILABLE
        assert result["body"].decode().startswith("not the leader")
        assert time.time() - t0 < 15.0
    finally:
        big.shutdown()


def test_standby_http_redirects_with_location(lighthouse) -> None:
    lighthouse.set_role(False, "10.0.0.9:29510", "http://10.0.0.9:29511", 3, 0)

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):  # noqa: ANN002, ANN003
            return None

    opener = urllib.request.build_opener(NoRedirect)
    with pytest.raises(urllib.error.HTTPError) as ei:
        opener.open(f"{lighthouse.http_address()}/status.json", timeout=5)
    assert ei.value.code == 307
    assert ei.value.headers["Location"] == "http://10.0.0.9:29511/status.json"
    body = opener.open(f"{lighthouse.http_address()}/metrics", timeout=5).read().decode()
    assert "tpuft_lighthouse_role 0" in body
    assert "tpuft_lighthouse_leader_epoch 3" in body


def test_server_regions_and_link_state_of_a_flat_lighthouse(lighthouse) -> None:
    assert lighthouse.regions() == {"role": "flat", "region": "", "regions": []}
    assert lighthouse.link_state("nobody") == 0


# -- the failover client --------------------------------------------------------------


def test_client_follows_redirect_to_leader(lighthouse) -> None:
    leader = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1, join_timeout_ms=500,
                                      http_bind=f"{HOST}:0")
    try:
        leader.set_role(True, leader.address(), leader.http_address(), 2, 0)
        lighthouse.set_role(False, leader.address(), leader.http_address(), 2, 0)
        client = _native.LighthouseClient(lighthouse.address(), connect_timeout_ms=2000)
        try:
            client.heartbeat("g7:z", step=3, timeout_ms=5000)
            # The client keeps the learned leader for its next calls.
            assert client.leader().role == 1
        finally:
            client.close()
        # LeaderInfo is answered by the standby itself, not redirected.
        client = _native.LighthouseClient(lighthouse.address())
        info = client.leader()
        client.close()
        assert info.role == 0 and info.leader.leader_address == leader.address()
        assert 'tpuft_replica_step{replica="g7:z"} 3' in _metrics(leader.http_address())
        assert 'replica="g7:z"' not in _metrics(lighthouse.http_address())
    finally:
        leader.shutdown()


# A loopback address no other test binds: a lighthouse there cannot take
# over a port another test's lighthouse just released while that test's
# Managers still heartbeat to it (they dial HOST).
PRIVATE_HOST = "127.0.0.29"


def test_client_rotates_past_dead_address() -> None:
    lighthouse = _native.LighthouseServer(bind=f"{PRIVATE_HOST}:0", min_replicas=1,
                                          join_timeout_ms=500, http_bind=f"{PRIVATE_HOST}:0")
    lighthouse.set_role(True, lighthouse.address(), lighthouse.http_address(), 1, 0)
    client = _native.LighthouseClient(f"{_dead_address()},{lighthouse.address()}",
                                      connect_timeout_ms=2000)
    try:
        client.heartbeat("g1:r", step=1, timeout_ms=8000)
        q = client.quorum("g1:r", timeout_ms=8000, step=1)
        assert [p.replica_id for p in q.participants] == ["g1:r"]
    finally:
        client.close()
        lighthouse.shutdown()


def test_manager_dead_address_list_raises_actionable_error() -> None:
    """The port's Manager against an all-dead list fails at once with an
    error naming every address (its native ManagerServer's), within about
    the connect timeout."""
    from torchft_tpu_torch.collectives import DummyCollective
    from torchft_tpu_torch.manager import Manager

    dead = f"{_dead_address()},{_dead_address()}"
    t0 = time.time()
    with pytest.raises(RuntimeError) as ei:
        Manager(collective=DummyCollective(), load_state_dict=None, state_dict=None,
                min_replica_size=1, rank=0, world_size=1, replica_id="dead",
                lighthouse_addr=dead, store_addr=HOST, manager_bind=f"{HOST}:0",
                connect_timeout=timedelta(seconds=1.5))
    msg = str(ei.value)
    assert "no lighthouse reachable" in msg and "TPUFT_LIGHTHOUSE" in msg
    for addr in dead.split(","):
        assert addr in msg
    assert time.time() - t0 < 10.0


def test_lighthouse_client_dead_list_raises_actionable_error() -> None:
    dead = f"{_dead_address()},{_dead_address()}"
    client = _native.LighthouseClient(dead, connect_timeout_ms=500)
    t0 = time.time()
    with pytest.raises(TimeoutError) as ei:
        client.heartbeat("g0:x", timeout_ms=1200)
    client.close()
    assert time.time() - t0 < 10.0
    msg = str(ei.value)
    assert "TPUFT_LIGHTHOUSE" in msg
    for addr in dead.split(","):
        assert addr in msg
    with pytest.raises(ValueError):
        _native.LighthouseClient(" , ")


def test_client_application_errors_are_final(lighthouse) -> None:
    """An application error (a drained replica's quorum refused "is
    draining") is raised at once with its wire status, not failed over."""
    client = _native.LighthouseClient(lighthouse.address())
    try:
        client.heartbeat("7:x")
        assert client.drain("7", deadline_ms=20000) == 1
        assert "7:x" in client.status().draining
        t0 = time.monotonic()
        with pytest.raises(RuntimeError) as ei:
            client.quorum("7:x", timeout_ms=5000)
        assert time.monotonic() - t0 < 2.0
        assert "draining" in str(ei.value)
        assert ei.value.wire_status not in (None, 14)
    finally:
        client.close()


# -- replication ---------------------------------------------------------------------


def test_replication_carries_state_and_fences_epochs(lighthouse) -> None:
    leader = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1, join_timeout_ms=500,
                                      http_bind=f"{HOST}:0")
    try:
        leader.set_role(True, leader.address(), leader.http_address(), 5, 0)
        c = _native.LighthouseClient(leader.address())
        c.heartbeat("g0:aa", step=11, state="step", step_time_ms_ewma=52.5,
                    step_time_ms_last=51.0)
        c.close()
        snap = leader.snapshot()
        assert len(snap) > 0
        lighthouse.set_role(False, "", "", 0, 0)
        standby = _native.LighthouseClient(lighthouse.address())
        resp = standby.replicate(snap)
        assert resp.applied and resp.leader_epoch == 5
        m = _metrics(lighthouse.http_address())
        assert 'tpuft_replica_step{replica="g0:aa"} 11' in m
        assert 'tpuft_replica_step_time_seconds{replica="g0:aa"}' in m and "0.0525" in m
        lighthouse.set_role(True, lighthouse.address(), lighthouse.http_address(), 7, 0)
        resp = standby.replicate(snap)
        assert not resp.applied and resp.leader_epoch == 7
        leader.set_role(True, leader.address(), leader.http_address(), 9, 0)
        resp = standby.replicate(leader.snapshot())
        standby.close()
        assert resp.applied and resp.leader_epoch == 9
        assert lighthouse.role() == 0 and lighthouse.leader_epoch() == 9
    finally:
        leader.shutdown()


# -- takeovers -----------------------------------------------------------------------


def _replica(cls, lease: str, peers=(), lease_ms: int = 700, **kw):
    return cls(lease_path=lease, peers=list(peers), lease_ms=lease_ms, min_replicas=1,
               join_timeout_ms=500, **kw)


def _crash(ha) -> None:
    """Stops a replica as a SIGKILL would: no lease release, no handoff."""
    ha._stop.set()
    ha._thread.join(timeout=5.0)
    ha._repl_thread.join(timeout=5.0)
    ha._server.shutdown()


def _pair(first_cls, second_cls, lease: str, **kw):
    """The first replica leads (it is elected before the second starts);
    both push to each other."""
    a = _replica(first_cls, lease, **kw)
    _wait(a.is_leader, what="the first replica's election")
    b = _replica(second_cls, lease, peers=[a.address()], **kw)
    a._peers = [b.address()]
    return a, b


def _takeover(a, b, client_addrs: str, rid: str) -> dict:
    """State through the leader ``a``, replicated to ``b``; ``a`` crashes;
    ``b`` takes over at the next epoch and still tracks the replica."""
    epoch0 = a.leader_epoch()
    client = _native.LighthouseClient(client_addrs)
    try:
        client.heartbeat(rid, step=21, state="step", step_time_ms_ewma=33.0,
                         step_time_ms_last=30.0)
        _wait(lambda: f'tpuft_replica_step{{replica="{rid}"}} 21' in _metrics(b.http_address()),
              what="replication to the standby")
        assert b.role() == "follower" and not b.is_leader()
        _crash(a)
        t_kill = time.monotonic()
        _wait(b.is_leader, what="the standby's takeover")
        takeover_s = time.monotonic() - t_kill
        assert b.leader_epoch() == epoch0 + 1 and b.role() == "leader"
        m = _metrics(b.http_address())
        assert f'tpuft_replica_step{{replica="{rid}"}} 21' in m
        assert f"tpuft_lighthouse_leader_epoch {epoch0 + 1}" in m
        # The client, still listing the dead leader first, reaches the new one.
        client.heartbeat(rid, step=22, timeout_ms=8000)
        assert rid in client.status().replica_step
        return {"epoch0": epoch0, "takeover_s": takeover_s}
    finally:
        client.close()


def test_ha_two_replica_takeover_e2e(tmp_path, monkeypatch) -> None:
    from torchft_tpu_torch.ha import HALighthouse
    from torchft_tpu_torch.obs import report

    metrics_path = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("TPUFT_METRICS_PATH", str(metrics_path))
    a, b = _pair(HALighthouse, HALighthouse, str(tmp_path / "lease"))
    try:
        assert a.role() == "leader" and a.leader_epoch() == 1
        out = _takeover(a, b, f"{a.address()},{b.address()}", "g0:e2e")
        assert out["takeover_s"] < 0.7 * 6
    finally:
        a.shutdown()
        b.shutdown()
    events = report.read_events([str(metrics_path)])
    failovers = [e for e in events if e.get("event") == "lighthouse_failover"]
    assert [e["leader_epoch"] for e in failovers] == [out["epoch0"] + 1]
    assert failovers[0]["replica_id"] == f"lighthouse:{b.address()}"


@pytest.mark.parametrize("order", ["jax_over_port", "port_over_jax"])
def test_mixed_takeover_on_one_lease_file(tmp_path, order) -> None:
    """A JAX and a port replica share one lease file and the wire: the
    second takes over when the first crashes, with the first's replicated
    state, at the next epoch."""
    from torchft_tpu_torch.ha import HALighthouse

    JaxHA = import_reference("torchft_tpu.ha.replica").HALighthouse
    first, second = (HALighthouse, JaxHA) if order == "jax_over_port" else (JaxHA, HALighthouse)
    lease = str(tmp_path / "lease")
    a, b = _pair(first, second, lease)
    try:
        _takeover(a, b, f"{a.address()},{b.address()}", f"g0:{order}")
        with open(lease) as f:
            lines = f.read().splitlines()
        assert lines[0] == "2" and lines[1] == b.address()
    finally:
        a.shutdown()
        b.shutdown()


def test_clean_shutdown_hands_over_without_waiting_out_the_lease(tmp_path) -> None:
    from torchft_tpu_torch.ha import HALighthouse

    a, b = _pair(HALighthouse, HALighthouse, str(tmp_path / "lease"), lease_ms=5000)
    try:
        t0 = time.monotonic()
        a.shutdown()
        _wait(b.is_leader, timeout=4.0, what="the handoff")
        assert time.monotonic() - t0 < 4.0 and b.leader_epoch() == 2
    finally:
        b.shutdown()


# -- the repair: the supervisor and the drain notice reach the new leader ------------


def _ha_after_kill(tmp_path, rids):
    """A port pair, the leader first in the list, the replicas ``rids``
    heartbeating through it and replicated, then the leader crashed and the
    standby leading.  Returns (the standby, "A,B")."""
    from torchft_tpu_torch.ha import HALighthouse

    a, b = _pair(HALighthouse, HALighthouse, str(tmp_path / "lease"),
                 heartbeat_timeout_ms=60000)
    addrs = f"{a.address()},{b.address()}"
    client = _native.LighthouseClient(a.address())
    for rid in rids:
        client.heartbeat(rid, step=1)
    client.close()
    _wait(lambda: all(f'replica="{rid}"' in _metrics(b.http_address()) for rid in rids),
          what="replication to the standby")
    _crash(a)
    _wait(b.is_leader, what="the standby's takeover")
    return a, b, addrs


def test_launcher_evict_and_drain_reach_the_new_leader_through_an_address_list(
        tmp_path) -> None:
    """The Launcher's evict of a dead group and its drain of a group go
    through ``"A,B"`` after A (the leader) died without releasing the lease:
    both land on B.  (A single-address client cannot parse the list and the
    survivors would pay the heartbeat timeout.)"""
    from torchft_tpu_torch.launch import Launcher

    a, b, addrs = _ha_after_kill(tmp_path, ["1:x", "2:x", "0:x"])
    try:
        launcher = Launcher([sys.executable, "-c", "pass"], num_groups=3, lighthouse=addrs,
                            log_dir=str(tmp_path))
        try:
            launcher._evict_from_lighthouse(1)
            launcher._drain_at_lighthouse(2, 30000)
        finally:
            if launcher._evict_client is not None:
                launcher._evict_client.close()
        status = _native.LighthouseClient(b.address())
        st = status.status()
        status.close()
        assert "1:x" not in st.heartbeat_age_ms and "0:x" in st.heartbeat_age_ms
        assert st.draining == ["2:x"]
    finally:
        a.shutdown()
        b.shutdown()


def test_manager_drain_notice_reaches_the_new_leader_through_an_address_list(
        tmp_path) -> None:
    from torchft_tpu_torch.collectives import DummyCollective
    from torchft_tpu_torch.drain import DrainNotice
    from torchft_tpu_torch.manager import Manager

    a, b, addrs = _ha_after_kill(tmp_path, ["0:x"])
    manager = None
    try:
        manager = Manager(collective=DummyCollective(), load_state_dict=None, state_dict=None,
                          min_replica_size=1, rank=0, world_size=1, replica_id="5",
                          lighthouse_addr=addrs, store_addr=HOST, manager_bind=f"{HOST}:0")
        t0 = time.monotonic()
        manager._notify_lighthouse_drain(DrainNotice(source="manual", deadline=time.time() + 30))
        assert time.monotonic() - t0 < 8.0
        client = _native.LighthouseClient(addrs)
        st = client.status()
        client.close()
        assert st.draining == [manager.replica_id()]
    finally:
        if manager is not None:
            manager.shutdown()
        a.shutdown()
        b.shutdown()


# -- the CLI as processes ------------------------------------------------------------


def _free_port() -> int:
    s = socket.socket()
    s.bind((HOST, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _cli(pkg: str, rpc: str, lease: str, peers: str, metrics: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": REPO, "TPUFT_METRICS_PATH": metrics,
           "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.lighthouse_cli", "--bind", rpc,
         "--http_bind", f"{HOST}:{_free_port()}", "--lease-file", lease, "--lease-ms", "700",
         "--peers", peers, "--min_replicas", "1", "--join_timeout_ms", "500"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)


def _leader_of(addrs: str):
    """The address among ``addrs`` whose replica reports itself leader."""
    for addr in addrs.split(","):
        client = _native.LighthouseClient(addr, connect_timeout_ms=500)
        try:
            if client.leader(timeout_ms=1000).role == 1:
                return addr
        except Exception:  # noqa: BLE001 - not up yet, or dead
            pass
        finally:
            client.close()
    return None


def test_lighthouse_cli_pair_takes_over_after_sigkill(tmp_path) -> None:
    """Two ``python -m torchft_tpu_torch.lighthouse_cli`` replicas on one
    lease file: SIGKILL of the leader's process, the other leads at epoch 2
    and logs one ``lighthouse_failover``; the remaining process exits 0 on
    SIGTERM."""
    rpcs = [f"{HOST}:{_free_port()}" for _ in range(2)]
    lease, metrics = str(tmp_path / "lease"), str(tmp_path / "m.jsonl")
    procs = [_cli("torchft_tpu_torch", rpcs[i], lease, rpcs[1 - i], metrics) for i in range(2)]
    try:
        addrs = ",".join(rpcs)
        _wait(lambda: _leader_of(addrs) is not None, timeout=30.0, what="a CLI leader")
        leader = _leader_of(addrs)
        i = rpcs.index(leader)
        procs[i].send_signal(signal.SIGKILL)
        procs[i].wait(timeout=10)
        _wait(lambda: _leader_of(rpcs[1 - i]) == rpcs[1 - i], timeout=10.0,
              what="the standby CLI's takeover")
        client = _native.LighthouseClient(addrs)
        info = client.leader(timeout_ms=5000)
        client.close()
        assert info.leader.leader_epoch == 2 and info.leader.leader_address == rpcs[1 - i]
        procs[1 - i].send_signal(signal.SIGTERM)
        assert procs[1 - i].wait(timeout=15) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    events = [json.loads(line) for line in open(metrics) if line.strip()]
    assert [e["leader_epoch"] for e in events if e["event"] == "lighthouse_failover"] == [2]


def test_lighthouse_cli_rejects_a_region_without_root() -> None:
    r = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.lighthouse_cli",
                        "--region", "r0"], cwd=REPO, capture_output=True, text=True,
                       timeout=120, env={**os.environ, "PYTHONPATH": REPO})
    assert r.returncode == 2 and "--region and --root-addrs" in r.stderr


# -- the report ----------------------------------------------------------------------


def test_report_charges_election_as_quorum_wait() -> None:
    from torchft_tpu_torch.obs import report

    t0 = 100.0
    events = [{"schema": 1, "event": "commit", "replica_id": "g0:a", "ts": ts, "t_mono": ts,
               "step": i, "committed": True}
              for i, ts in enumerate([t0, t0 + 1, t0 + 2, t0 + 4, t0 + 5])]
    events.append({"schema": 1, "event": "fault", "kind": "lighthouse", "group": "lighthouse",
                   "ts": t0 + 2.2, "replica_id": "bench"})
    events.append({"schema": 1, "event": "lighthouse_failover", "leader_epoch": 2,
                   "ts": t0 + 3.0, "replica_id": "lh"})
    assert report.election_windows(events) == [(t0 + 2.2, t0 + 3.0)]
    assert report.fault_times(events) == []
    out = report.attribute(events)
    assert out["goodput"]["lighthouse_elections"] == 1
    assert out["totals"]["election_s"] == pytest.approx(0.8, abs=0.01)
    assert out["totals"]["quorum_wait_s"] >= 0.8 - 0.01
