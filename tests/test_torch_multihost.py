"""The port's slice bootstrap, the counterpart of tests/test_multihost.py:
the env contract, the single-process no-op, the Store requirement, a
rendezvous of four ranks through one real StoreServer, and two real
processes that form one gloo world through the port's Store, then restart
as generation 1 and must not read generation 0's coordinator."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading

import pytest

from torchft_tpu_torch.coordination import StoreServer
from torchft_tpu_torch.multihost import SliceConfig, initialize_slice, slice_config_from_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_from_env_defaults() -> None:
    cfg = slice_config_from_env(env={})
    assert cfg.host_rank == 0 and cfg.num_hosts == 1
    assert cfg.coord_port == 8476 and cfg.generation == 0 and cfg.store_addr is None
    assert not cfg.is_multihost
    cfg = slice_config_from_env(env={"TPUFT_HOST_RANK": "1", "TPUFT_NUM_HOSTS": "2",
                                     "TPUFT_STORE": "h:1", "TPUFT_COORD_PORT": "9",
                                     "TPUFT_SLICE_GEN": "3"})
    assert cfg == SliceConfig(host_rank=1, num_hosts=2, store_addr="h:1", coord_port=9,
                              generation=3)


def test_single_host_is_noop() -> None:
    calls = []
    out = initialize_slice(
        SliceConfig(host_rank=0, num_hosts=1, store_addr=None),
        backend="gloo",
        _initialize=lambda **kw: calls.append(kw),
    )
    assert out is None and calls == []


def test_multihost_requires_store() -> None:
    with pytest.raises(RuntimeError, match="TPUFT_STORE"):
        initialize_slice(
            SliceConfig(host_rank=0, num_hosts=2, store_addr=None),
            backend="gloo",
            _initialize=lambda **kw: None,
        )


def test_rendezvous_all_hosts_agree() -> None:
    """4 ranks (threads) rendezvous through one real StoreServer; every
    init_process_group call gets the same coordinator, its own rank, the
    world size 4 and the backend asked for."""
    server = StoreServer(bind="127.0.0.1:0")
    try:
        calls = {}
        lock = threading.Lock()

        def host(rank: int):
            def fake_init(backend, init_method, world_size, rank):
                with lock:
                    calls[rank] = (init_method, world_size, backend)

            initialize_slice(
                SliceConfig(host_rank=rank, num_hosts=4, store_addr=server.address(),
                            coord_port=9999),
                backend="gloo",
                key_prefix="test_slice",
                _initialize=fake_init,
            )

        threads = [threading.Thread(target=host, args=(r,)) for r in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert sorted(calls) == [0, 1, 2, 3]
        coords = {c for c, _, _ in calls.values()}
        assert len(coords) == 1, f"ranks disagree on coordinator: {coords}"
        assert all(n == 4 and b == "gloo" for _, n, b in calls.values())
        coord = next(iter(coords))
        assert coord.startswith("tcp://") and coord.endswith(":9999")

        # Restart incarnation: generation 1 must NOT read generation 0's
        # (stale) coordinator from the still-live store.
        got = {}

        def host2(rank: int):
            initialize_slice(
                SliceConfig(host_rank=rank, num_hosts=2, store_addr=server.address(),
                            coord_port=7777, generation=1),
                backend="gloo",
                key_prefix="test_slice",
                _initialize=lambda backend, init_method, world_size, rank: got.setdefault(
                    rank, init_method),
            )

        threads = [threading.Thread(target=host2, args=(r,)) for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert sorted(got) == [0, 1]
        assert all(c.endswith(":7777") for c in got.values()), got
    finally:
        server.shutdown()


_CHILD = r"""
import os, sys

sys.path.insert(0, os.environ["TPUFT_REPO"])

import torch
import torch.distributed as dist

from torchft_tpu_torch.multihost import initialize_slice

coordinator = initialize_slice(backend="gloo")  # REAL init_process_group

assert dist.get_world_size() == 2, dist.get_world_size()
# One value through the process group: both ranks see both ranks' sum.
x = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(x)
assert x.item() == 3.0, x
print("OK", os.environ["TPUFT_HOST_RANK"], coordinator, flush=True)
dist.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_pair(store_addr: str, generation: int, coord_port: int):
    """Two real OS processes bootstrap one group through the live Store."""
    procs = []
    for rank in (0, 1):
        env = dict(
            os.environ,
            TPUFT_REPO=REPO,
            TPUFT_HOST_RANK=str(rank),
            TPUFT_NUM_HOSTS="2",
            TPUFT_STORE=store_addr,
            TPUFT_COORD_PORT=str(coord_port),
            TPUFT_SLICE_GEN=str(generation),
            MASTER_ADDR="127.0.0.1",
            OMP_NUM_THREADS="1",
        )
        procs.append(subprocess.Popen([sys.executable, "-c", _CHILD], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
            assert p.returncode == 0, f"child failed:\n{out}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def test_two_real_processes_rendezvous_and_restart_generation() -> None:
    """Two actual processes rendezvous through a real StoreServer, form one
    gloo world and sum across it.  The group then 'dies' and restarts as
    generation 1: generation 0's key is still in the store, and the
    restarted pair must rendezvous on the new key and port, not dial the
    dead coordinator."""
    server = StoreServer(bind="127.0.0.1:0")
    try:
        port0 = _free_port()
        outs0 = _run_pair(server.address(), generation=0, coord_port=port0)
        assert any(f":{port0}" in o for o in outs0), outs0

        port1 = _free_port()
        outs1 = _run_pair(server.address(), generation=1, coord_port=port1)
        assert any(f":{port1}" in o for o in outs1), outs1
        for out in outs1:
            assert f":{port0}" not in out
    finally:
        server.shutdown()
