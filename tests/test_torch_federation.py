"""The port's federated control plane (torchft_tpu_torch/federation) against
the JAX package's ``tests/test_federation.py`` contract.

Two regions and a root on the CPU: the root forms one global quorum over the
regions' digests alone (no heartbeat RPC reaches it), both regions are fresh
in its rollup, and the Managers of both regions join one quorum id.  Then a
JAX region and a port region under one root, a region that is an HA group,
the CLI as processes, and the constructors' checks.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from datetime import timedelta

import pytest

from torch_port_ref import REPO, import_reference
from torchft_tpu_torch import _native, federation

HOST = "127.0.0.1"


def _wait(cond, timeout: float = 20.0, what: str = "condition") -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.05)


def _rpc_count(http: str, method: str) -> int:
    """The count of ``tpuft_rpc_latency_seconds{method=...}`` on a
    lighthouse's /metrics (0 when the series is absent)."""
    text = urllib.request.urlopen(f"{http}/metrics", timeout=5).read().decode()
    for line in text.splitlines():
        if line.startswith("tpuft_rpc_latency_seconds_count") and f'method="{method}"' in line:
            return int(float(line.rsplit(" ", 1)[1]))
    return 0


def _join_all(clients_and_ids, timeout_ms: int = 20000) -> dict:
    """Each (LighthouseClient, replica id) asks its region for a quorum at
    once; returns replica id -> quorum."""
    out: dict = {}

    def ask(client, rid) -> None:
        out[rid] = client.quorum(rid, timeout_ms=timeout_ms, address=f"{HOST}:1",
                                 store_address=f"{HOST}:2", step=3)

    threads = [threading.Thread(target=ask, args=cr) for cr in clients_and_ids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout_ms / 1e3 + 5)
    return out


def test_exports_are_lazy_and_constructors_check_their_arguments() -> None:
    assert set(federation.__all__) == {"RegionLighthouse", "RootLighthouse"}
    with pytest.raises(AttributeError):
        federation.Nothing  # noqa: B018
    with pytest.raises(ValueError, match="region"):
        federation.RegionLighthouse("", f"{HOST}:1")
    with pytest.raises(ValueError, match="root_addrs"):
        federation.RegionLighthouse("r0", "")


def test_two_regions_and_a_root_form_one_quorum_with_port_managers() -> None:
    """A root at min_replicas 2 and two regions, one port Manager in each:
    both start_quorum calls return one quorum id with 2 participants; the
    root's rollup has both regions fresh, and the root served digests, no
    heartbeat."""
    from torchft_tpu_torch.collectives import DummyCollective
    from torchft_tpu_torch.manager import Manager

    root = federation.RootLighthouse(min_replicas=2, join_timeout_ms=500)
    regions = [federation.RegionLighthouse(f"r{i}", root.address(), push_interval_ms=100,
                                           join_timeout_ms=500) for i in range(2)]
    managers = []
    try:
        assert root.wait_for_regions(2, timeout_s=20.0)
        timeout = timedelta(seconds=20)
        managers = [Manager(collective=DummyCollective(), load_state_dict=None, state_dict=None,
                            min_replica_size=2, rank=0, world_size=1, replica_id=f"fed{i}",
                            lighthouse_addr=regions[i].address(), store_addr=HOST,
                            manager_bind=f"{HOST}:0", timeout=timeout, quorum_timeout=timeout,
                            init_sync=False)
                    for i in range(2)]
        for m in managers:
            m.start_quorum()
        for m in managers:
            m.wait_quorum()
        assert [m.num_participants() for m in managers] == [2, 2]
        assert managers[0]._quorum_id == managers[1]._quorum_id > 0
        rollup = root.regions()
        assert rollup["role"] == "root"
        rows = {r["region"]: r for r in rollup["regions"]}
        assert set(rows) == {"r0", "r1"} and not any(r["stale"] for r in rows.values())
        assert regions[0].regions()["role"] == "child" and regions[0].is_leader()
        assert _rpc_count(root.http_address(), "Heartbeat") == 0
        assert _rpc_count(root.http_address(), "RegionDigest") > 0
    finally:
        for m in managers:
            m.shutdown()
        for r in regions:
            r.shutdown()
        root.shutdown()


@pytest.mark.parametrize("root_pkg", ["port", "jax"])
def test_a_jax_region_and_a_port_region_under_one_root(root_pkg) -> None:
    """One root (the port's or the JAX package's), a JAX region and a port
    region, one replica joining through each: one global quorum of both."""
    jax_fed = import_reference("torchft_tpu.federation")
    root_cls = federation.RootLighthouse if root_pkg == "port" else jax_fed.RootLighthouse
    root = root_cls(min_replicas=2, join_timeout_ms=500)
    port_region = federation.RegionLighthouse("port", root.address(), push_interval_ms=100)
    jax_region = jax_fed.RegionLighthouse("jax", root.address(), push_interval_ms=100)
    clients = [_native.LighthouseClient(port_region.address()),
               import_reference("torchft_tpu._native").LighthouseClient(jax_region.address())]
    try:
        assert root.wait_for_regions(2, timeout_s=20.0)
        got = _join_all([(clients[0], "p:1"), (clients[1], "j:1")])
        assert set(got) == {"p:1", "j:1"}
        assert got["p:1"].quorum_id == got["j:1"].quorum_id
        for q in got.values():
            assert sorted(m.replica_id for m in q.participants) == ["j:1", "p:1"]
        assert {r["region"] for r in root.regions()["regions"]} == {"port", "jax"}
    finally:
        for c in clients:
            c.close()
        port_region.shutdown()
        jax_region.shutdown()
        root.shutdown()


def test_an_ha_region_pushes_from_its_leader(tmp_path) -> None:
    """A region that is an HA group of two replicas: only the lease holder
    pushes; the region is fresh at the root and a quorum forms through it."""
    root = federation.RootLighthouse(min_replicas=1, join_timeout_ms=500)
    lease = str(tmp_path / "lease")
    r0 = federation.RegionLighthouse("ha", root.address(), push_interval_ms=100,
                                     lease_path=lease, lease_ms=700)
    _wait(r0.is_leader, what="the region's election")
    r1 = federation.RegionLighthouse("ha", root.address(), push_interval_ms=100,
                                     lease_path=lease, lease_ms=700, peers=[r0.address()])
    client = _native.LighthouseClient(f"{r1.address()},{r0.address()}")
    try:
        assert not r1.is_leader()
        assert root.wait_for_regions(1, timeout_s=20.0)
        q = client.quorum("h:1", timeout_ms=20000, step=1)
        assert [m.replica_id for m in q.participants] == ["h:1"]
        rows = root.regions()["regions"]
        assert [r["region"] for r in rows] == ["ha"] and rows[0]["child_epoch"] == 1
    finally:
        client.close()
        r1.shutdown()
        r0.shutdown()
        root.shutdown()


def _free_port() -> int:
    s = socket.socket()
    s.bind((HOST, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_lighthouse_cli_root_and_two_regions_as_processes() -> None:
    """``python -m torchft_tpu_torch.lighthouse_cli`` as a root and two
    regions: one quorum through both regions, fresh regions at the root,
    no heartbeat RPC at the root."""
    root_rpc, root_http = f"{HOST}:{_free_port()}", f"{HOST}:{_free_port()}"
    env = {**os.environ, "PYTHONPATH": REPO, "CUDA_VISIBLE_DEVICES": ""}

    def cli(*args: str) -> subprocess.Popen:
        return subprocess.Popen([sys.executable, "-m", "torchft_tpu_torch.lighthouse_cli",
                                 *args], cwd=REPO, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)

    procs = [cli("--bind", root_rpc, "--http_bind", root_http, "--min_replicas", "2",
                 "--join_timeout_ms", "500")]
    rpcs = []
    for name in ("r0", "r1"):
        rpcs.append(f"{HOST}:{_free_port()}")
        procs.append(cli("--bind", rpcs[-1], "--http_bind", f"{HOST}:{_free_port()}",
                         "--region", name, "--root-addrs", root_rpc,
                         "--region-push-interval-ms", "100"))
    clients = [_native.LighthouseClient(a, connect_timeout_ms=30000) for a in rpcs]
    try:
        got = _join_all([(clients[0], "a:1"), (clients[1], "b:1")], timeout_ms=40000)
        assert got["a:1"].quorum_id == got["b:1"].quorum_id
        assert len(got["a:1"].participants) == 2
        http = f"http://{root_http}"
        rollup = urllib.request.urlopen(f"{http}/regions.json", timeout=5).read().decode()
        assert '"r0"' in rollup and '"r1"' in rollup
        assert _rpc_count(http, "Heartbeat") == 0
    finally:
        for c in clients:
            c.close()
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                assert p.wait(timeout=15) == 0
            finally:
                if p.poll() is None:
                    p.kill()
