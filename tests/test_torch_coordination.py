"""The port's coordination API (torchft_tpu_torch/coordination.py): the JAX
package's ``tests/test_coordination.py`` on the port's own bindings and wire
types, plus the store CLI as a process and the wire types' identity.
"""

import json
import threading
import time
import urllib.request

import pytest

from torchft_tpu_torch import coordination
from torchft_tpu_torch.coordination import (
    LighthouseClient,
    LighthouseServer,
    ManagerClient,
    ManagerServer,
    StoreClient,
    StoreServer,
)


def test_coordination_docstrings() -> None:
    for name in coordination.__all__:
        obj = getattr(coordination, name)
        assert obj.__doc__, f"{name} missing docstring"


def test_lighthouse_join_two_replicas() -> None:
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=100)
    try:
        results = {}

        def join(replica_id: str) -> None:
            client = LighthouseClient(lh.address())
            results[replica_id] = client.quorum(replica_id, timeout_ms=5000, step=0)
            client.close()

        t0 = time.monotonic()
        threads = [threading.Thread(target=join, args=(f"replica{i}",)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        elapsed = time.monotonic() - t0
        # Reference guard: quorum join < 0.4s with 100ms join timeout
        # (torchft/lighthouse_test.py:45-48).
        assert elapsed < 0.4, f"quorum took {elapsed:.3f}s"
        assert len(results["replica0"].participants) == 2
        assert results["replica0"].quorum_id == results["replica1"].quorum_id
    finally:
        lh.shutdown()


def test_lighthouse_timeout_returns_fast() -> None:
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=2, join_timeout_ms=100)
    try:
        client = LighthouseClient(lh.address())
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            client.quorum("lonely", timeout_ms=300)
        # Reference guard: timed-out quorum returns < 1.0s
        # (torchft/manager_integ_test.py:450-462).
        assert time.monotonic() - t0 < 1.0
    finally:
        lh.shutdown()


def test_lighthouse_user_data_roundtrip() -> None:
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100)
    try:
        client = LighthouseClient(lh.address())
        quorum = client.quorum(
            "replica0", timeout_ms=5000, data={"role": "trainer", "shards": [1, 2]}
        )
        member = quorum.participants[0]
        assert json.loads(member.data) == {"role": "trainer", "shards": [1, 2]}
    finally:
        lh.shutdown()


def test_lighthouse_heartbeat_and_status() -> None:
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100)
    try:
        client = LighthouseClient(lh.address())
        client.heartbeat("replica0")
        status = client.status()
        assert "replica0" in status.heartbeat_age_ms
    finally:
        lh.shutdown()


def test_lighthouse_dashboard_http() -> None:
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                          http_bind="127.0.0.1:0")
    try:
        client = LighthouseClient(lh.address())
        client.quorum("replica0", timeout_ms=5000, step=3)
        url = lh.http_address()
        html = urllib.request.urlopen(url + "/", timeout=5).read().decode()
        assert "replica0" in html and "lighthouse" in html
        blob = json.loads(
            urllib.request.urlopen(url + "/status.json", timeout=5).read().decode()
        )
        assert blob["participants"][0]["replica_id"] == "replica0"
        assert blob["participants"][0]["step"] == 3
    finally:
        lh.shutdown()


def test_manager_quorum_and_commit() -> None:
    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=50)
    mgr = ManagerServer(
        replica_id="group0",
        lighthouse_addr=lh.address(),
        bind="127.0.0.1:0",
        store_addr="store0:0",
        world_size=2,
    )
    try:
        results = {}

        def rank_flow(rank: int) -> None:
            client = ManagerClient(mgr.address())
            q = client._quorum(
                group_rank=rank,
                step=0,
                checkpoint_metadata=f"ckpt{rank}",
                shrink_only=False,
                timeout_ms=5000,
            )
            commit = client.should_commit(rank, 0, True, timeout_ms=5000)
            results[rank] = (q, commit)
            client.close()

        threads = [threading.Thread(target=rank_flow, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        q0, commit0 = results[0]
        assert q0.replica_world_size == 1
        assert q0.replica_rank == 0
        assert not q0.heal
        assert commit0 is True

        # Peer metadata fetch (the healing path's first RPC,
        # torchft/manager.py:536-540).
        client = ManagerClient(mgr.address())
        assert client._checkpoint_metadata(1, timeout_ms=5000) == "ckpt1"
    finally:
        mgr.shutdown()
        lh.shutdown()


def _multi_group_quorum(steps, init_sync=True, min_replicas=None):
    """Runs one real Lighthouse + one real ManagerServer per replica group
    (world_size=1) and collects each group's quorum response.

    Exercises the NATIVE compute_quorum_results recovery planning end to
    end (reference's pure-function tests: src/manager.rs:381-509 edge
    cases), not a mocked QuorumResult."""
    n = len(steps)
    lh = LighthouseServer(
        bind="127.0.0.1:0",
        min_replicas=min_replicas or n,
        join_timeout_ms=2000,
    )
    mgrs = []
    try:
        for g in range(n):
            mgrs.append(
                ManagerServer(
                    replica_id=f"g{g}",
                    lighthouse_addr=lh.address(),
                    bind="127.0.0.1:0",
                    store_addr=f"store{g}:0",
                    world_size=1,
                )
            )
        results = {}

        def flow(g: int) -> None:
            client = ManagerClient(mgrs[g].address())
            try:
                results[g] = client._quorum(
                    group_rank=0,
                    step=steps[g],
                    checkpoint_metadata=f"ckpt{g}",
                    shrink_only=False,
                    timeout_ms=10000,
                    init_sync=init_sync,
                )
            finally:
                client.close()

        threads = [threading.Thread(target=flow, args=(g,)) for g in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert sorted(results) == list(range(n)), f"missing quorums: {results.keys()}"
        return results
    finally:
        for m in mgrs:
            m.shutdown()
        lh.shutdown()


def test_quorum_recovery_plan_behind_group_heals() -> None:
    """Groups at steps (5, 5, 0): the behind group gets heal=True with the
    full ordered donor rotation (primary first); EVERY up-to-date group's
    response lists it as a destination — all donors open their serving
    windows so the receiver can stripe its fetch across them."""
    res = _multi_group_quorum([5, 5, 0])
    behind = res[2]
    assert behind.heal
    assert behind.max_step == 5
    up_to_date_ranks = {res[0].replica_rank, res[1].replica_rank}
    assert behind.recover_src_replica_rank in up_to_date_ranks
    assert behind.recover_src_manager_address
    # The donor rotation covers every up-to-date group, primary first.
    assert list(behind.recover_src_replica_ranks)[0] == behind.recover_src_replica_rank
    assert set(behind.recover_src_replica_ranks) == up_to_date_ranks
    assert behind.recover_src_manager_addresses[0] == behind.recover_src_manager_address
    assert len(behind.recover_src_manager_addresses) == len(up_to_date_ranks)
    # Field 11 keeps primary-only semantics: exactly one healthy group owns
    # the assignment (point-to-point transports serve only this)...
    dsts = [list(res[g].recover_dst_replica_ranks) for g in (0, 1)]
    assert sorted(d for ds in dsts for d in ds) == [behind.replica_rank]
    # ...while the _all set makes EVERY healthy group open its pull-serving
    # window for the striped fetch.
    dsts_all = [list(res[g].recover_dst_replica_ranks_all) for g in (0, 1)]
    assert all(ds == [behind.replica_rank] for ds in dsts_all)
    # Up-to-date groups do not heal and agree on max_step.
    for g in (0, 1):
        assert not res[g].heal
        assert res[g].max_step == 5


def test_quorum_recovery_round_robin_spreads_sources() -> None:
    """Two behind groups, two up to date: recovery sources are striped, not
    all assigned to one server (reference round-robin, (i+rank)%up_to_date)."""
    res = _multi_group_quorum([7, 7, 0, 0])
    behind = [res[g] for g in (2, 3)]
    assert all(b.heal for b in behind)
    srcs = {b.recover_src_replica_rank for b in behind}
    assert len(srcs) == 2, f"both behind groups healed from one source: {srcs}"


def test_quorum_init_sync_at_step_zero() -> None:
    """All at step 0 with init_sync: everyone but replica 0 syncs initial
    weights from it; with init_sync=False nobody heals."""
    res = _multi_group_quorum([0, 0, 0], init_sync=True)
    healers = [g for g in res if res[g].heal]
    nonhealers = [g for g in res if not res[g].heal]
    assert len(nonhealers) == 1 and len(healers) == 2
    src_rank = res[nonhealers[0]].replica_rank
    assert all(res[g].recover_src_replica_rank == src_rank for g in healers)

    res2 = _multi_group_quorum([0, 0, 0], init_sync=False)
    assert not any(res2[g].heal for g in res2)


def test_store_roundtrip_and_prefix() -> None:
    store = StoreServer(bind="127.0.0.1:0")
    try:
        client = StoreClient(store.address(), prefix="q0")
        client.set("rank0", b"addr0")
        assert client.get("rank0") == b"addr0"
        other = StoreClient(store.address(), prefix="q1")
        assert other.get("rank0", wait=False) is None
        with pytest.raises(TimeoutError):
            other.get("rank0", wait=True, timeout_ms=200)
        assert client.add("counter", 3) == 3
        assert client.add("counter", 2) == 5
        sub = client.sub_store("inner")
        sub.set("k", b"v")
        assert sub.get("k") == b"v"
        assert client.get("inner/k") == b"v"
    finally:
        store.shutdown()


def test_quorum_types_are_the_ports_wire_types() -> None:
    from torchft_tpu_torch import _wire

    assert coordination.Quorum is _wire.MESSAGES["Quorum"]
    assert coordination.QuorumMember is _wire.MESSAGES["QuorumMember"]
    q = coordination.Quorum(quorum_id=3, participants=[{"replica_id": "a", "step": 2}])
    assert isinstance(q.participants[0], coordination.QuorumMember)
    assert coordination.Quorum.FromString(q.SerializeToString()) == q
    with pytest.raises(ValueError):
        coordination.Quorum(quorum=1)


def test_store_cli_serves_until_interrupted() -> None:
    import os
    import signal
    import socket
    import subprocess
    import sys

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen([sys.executable, "-m", "torchft_tpu_torch.store_cli", "--bind",
                             f"127.0.0.1:{port}"], cwd=repo, stdout=subprocess.PIPE, text=True,
                            env={**os.environ, "PYTHONPATH": repo, "CUDA_VISIBLE_DEVICES": ""})
    try:
        line = proc.stdout.readline()
        assert line.startswith("[tpuft_store] listening on ") and str(port) in line
        client = StoreClient(f"127.0.0.1:{port}", prefix="cli")
        client.set("k", b"v")
        assert client.get("k") == b"v"
        client.close()
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=15) == 130
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
