"""The port Manager's metrics stream, spans and heartbeat telemetry, held
against the JAX Manager's.

- Mixed quorum: one JAX and one port Manager, each writing its own
  ``TPUFT_METRICS_PATH`` stream, take three steps of allreduce + averager
  + ``should_commit``.  Per step both streams hold the same event names,
  span phases, ``committed`` and ``step``; the JAX and the port report
  give equal results over the merged streams; the port's status pushes
  reach the lighthouse's heartbeats and its ledger the lighthouse's
  ``/goodput.json``; both managers' flight recorders read the same
  through either package's consumers.
- Heal: two port Managers over the HTTP transport: the healer's stream
  holds ``heal_start``, a ``heal`` span and ``heal_fetched`` with the
  fetch's bytes, the donor's a ``snapshot`` span.
- ``ManagerServer.set_status`` / ``set_ledger`` of the port feed the
  lighthouse's ``/status.json`` and ``/goodput.json`` (twins of the JAX
  package's tests of the same).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from datetime import timedelta
from typing import Any, Callable, Dict, List

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing import HTTPTransport
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.ddp import GradientAverager
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.obs import flight as port_flight
from torchft_tpu_torch.obs import report as port_report
from torchft_tpu_torch.obs.ledger import LOST_CAUSES

HOST = "127.0.0.1"
TIMEOUT = timedelta(seconds=30)
CHUNK = 4 << 10
BUCKET = 16 << 10


@pytest.fixture(scope="module")
def ref():
    return {name: import_reference(f"torchft_tpu.{name}")
            for name in ("manager", "collectives", "ddp", "obs.report", "obs.flight")}


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def _poll(fn: Callable[[], Any], done: Callable[[Any], bool], timeout_s: float = 10.0) -> Any:
    deadline = time.monotonic() + timeout_s
    while True:
        got = fn()
        if done(got) or time.monotonic() > deadline:
            return got
        time.sleep(0.05)


def _run_threads(fns: List[Callable[[], Any]]) -> List[Any]:
    out: List[Any] = [None] * len(fns)
    errs: List[BaseException] = []

    def wrap(i: int, fn) -> None:
        try:
            out[i] = fn()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errs.append(e)

    threads = [threading.Thread(target=wrap, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a replica thread hung"
    if errs:
        raise errs[0]
    return out


def _grads(gid: int, step: int) -> List[np.ndarray]:
    rng = np.random.default_rng(100 * gid + step)
    return [np.asarray(rng.standard_normal(s), dtype=np.float32)
            for s in [(64, 33), (6000,), (17,), ()]]


def _per_step(events: List[dict]) -> Dict[int, dict]:
    """step -> (event names, span phases, committed) of one stream; the
    heartbeat-free events only (quorum-thread events carry the step the
    quorum ran at)."""
    out: Dict[int, dict] = {}
    for e in events:
        step = e.get("step", e.get("max_step"))
        if step is None:
            continue
        d = out.setdefault(int(step), {"events": set(), "phases": set(), "committed": None})
        d["events"].add(e["event"])
        if e["event"] == "span":
            d["phases"].add(e["phase"])
        if e["event"] == "commit":
            d["committed"] = e["committed"]
    return out


def test_mixed_quorum_streams_reports_and_heartbeats(ref, tmp_path, monkeypatch) -> None:
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=2,
                                  join_timeout_ms=100)
    paths = [str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")]
    managers: List[Any] = []
    try:
        # Each Manager reads TPUFT_METRICS_PATH once, when it is made.
        monkeypatch.setenv("TPUFT_METRICS_PATH", paths[0])
        managers.append(ref["manager"].Manager(
            collective=ref["collectives"].TCPCollective(timeout=30.0, chunk_bytes=CHUNK),
            load_state_dict=None, state_dict=None, min_replica_size=2, timeout=TIMEOUT,
            quorum_timeout=TIMEOUT, rank=0, world_size=1, replica_id="jax0",
            lighthouse_addr=lh.address(), init_sync=False,
        ))
        monkeypatch.setenv("TPUFT_METRICS_PATH", paths[1])
        managers.append(Manager(
            collective=TCPCollective(timeout=30.0, chunk_bytes=CHUNK, host=HOST),
            load_state_dict=None, state_dict=None, min_replica_size=2, timeout=TIMEOUT,
            quorum_timeout=TIMEOUT, rank=0, world_size=1, replica_id="port1",
            lighthouse_addr=lh.address(), store_addr=HOST, manager_bind=f"{HOST}:0",
            init_sync=False,
        ))

        def run(g: int):
            m = managers[g]
            for s in range(3):
                m.start_quorum()
                x = np.arange(3001, dtype=np.float32) * (g + 1) + s
                if g == 0:
                    np.asarray(m.allreduce(x).result())
                    ref["ddp"].GradientAverager(m, bucket_bytes=BUCKET).allreduce(_grads(g, s))
                else:
                    m.allreduce(torch.from_numpy(x)).result()
                    GradientAverager(m, bucket_bytes=BUCKET).allreduce(
                        [torch.from_numpy(a) for a in _grads(g, s)])
                assert m.should_commit()
            return m.current_step()

        assert _run_threads([lambda g=g: run(g) for g in range(2)]) == [3, 3]
        port = managers[1]
        # The port's pushes reach the lighthouse: step and busy-time EWMA on
        # the heartbeats, the ledger's counters on /goodput.json.
        http = lh.http_address()
        rid = port._replica_id
        status = _poll(lambda: json.loads(_get(f"{http}/status.json")),
                       lambda st: st["replica_step"].get(rid) == 3
                       and st.get("replica_step_time_ms", {}).get(rid, 0) > 0)
        assert status["replica_step"][rid] == 3 and status["replica_state"][rid] == "step"
        # The lighthouse keeps whole milliseconds.
        assert abs(status["replica_step_time_ms"][rid] - port._step_stats.ewma_ms) <= 1.0
        goodput = _poll(lambda: json.loads(_get(f"{http}/goodput.json")),
                        lambda doc: rid in doc.get("per_replica", {}))
        ratio, compute_s, lost = port.ledger.heartbeat_vector()
        assert goodput["per_replica"][rid]["goodput_ratio"] == pytest.approx(ratio, abs=1e-6)
        assert set(goodput["per_replica"][rid]["lost_seconds"]) == set(LOST_CAUSES)
        assert compute_s > 0
        # Both packages read the port manager's and the lighthouse's flight
        # recorders alike.
        for dump in (port._manager_server.flight(), lh.flight()):
            assert dump["events"], dump
            fes = ref["obs.flight"].flight_events(dump)
            assert port_flight.flight_events(dump) == fes
            assert port_flight.flight_to_stream(dump) == ref["obs.flight"].flight_to_stream(dump)
            assert (port_flight.quorum_transitions(fes)
                    == ref["obs.flight"].quorum_transitions(fes))
        assert port_flight.quorum_transitions(port_flight.flight_events(lh.flight()))
        assert any(e.get("kind") == "rpc" and e.get("trace_id")
                   for e in port_flight.flight_events(port._manager_server.flight()))
    finally:
        for m in managers:
            m.shutdown()
        lh.shutdown()

    streams = [port_report.read_events([p]) for p in paths]
    by_step = [_per_step(evs) for evs in streams]
    assert sorted(by_step[0]) == sorted(by_step[1]) == [0, 1, 2]
    for s in range(3):
        a, b = by_step[0][s], by_step[1][s]
        assert a["committed"] is b["committed"] is True, s
        assert a["phases"] == b["phases"], (s, a["phases"], b["phases"])
        assert a["events"] == b["events"], (s, a["events"], b["events"])
    assert {"quorum", "configure", "allreduce_d2h", "allreduce_merge", "allreduce_h2d",
            "commit_vote"} <= by_step[1][0]["phases"]
    assert {"quorum", "reconfigure", "membership_change", "commit", "span",
            "step_summary"} <= by_step[1][0]["events"]
    summaries = [[e for e in evs if e["event"] == "step_summary"] for evs in streams]
    for a, b in zip(*summaries):
        assert a["step"] == b["step"] and a["committed"] == b["committed"]
        for key in ("step_wall_ms", "step_time_ms", "ledger", "allreduce_bytes",
                    "allreduce_lanes", "d2h_bytes"):
            assert (key in a) == (key in b), (key, a, b)
    assert summaries[1][-1]["allreduce_lanes"]["hops"]["flat"]["hops"] > 0
    merged = port_report.read_events(paths)
    want = ref["obs.report"].attribute(merged)
    assert json.dumps(port_report.attribute(merged), sort_keys=True) == json.dumps(
        want, sort_keys=True)
    assert [r["step"] for r in want["steps"]] == [1, 2] and want["ledger"]["per_replica"]


def test_port_heal_streams_heal_and_snapshot(tmp_path, monkeypatch) -> None:
    """Two port groups over the HTTP transport with init_sync: the healer's
    stream holds the heal's events and span with the fetch's bytes, the
    donor's its snapshot span; every span lands in a step_summary."""
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=2,
                                  join_timeout_ms=100)
    paths = [str(tmp_path / f"g{g}.jsonl") for g in range(2)]
    weights = [torch.full((1000,), float(g + 1)) for g in range(2)]
    managers: List[Manager] = []
    try:
        for g in range(2):
            monkeypatch.setenv("TPUFT_METRICS_PATH", paths[g])
            managers.append(Manager(
                collective=TCPCollective(timeout=30.0, chunk_bytes=CHUNK, host=HOST),
                load_state_dict=lambda sd, g=g: weights[g].copy_(sd["w"]),
                state_dict=lambda g=g: {"w": weights[g]}, min_replica_size=1,
                timeout=TIMEOUT, quorum_timeout=TIMEOUT, rank=0, world_size=1,
                replica_id=f"heal{g}", lighthouse_addr=lh.address(), store_addr=HOST,
                manager_bind=f"{HOST}:0", checkpoint_transport=HTTPTransport(timeout=30.0,
                                                                            host=HOST),
            ))

        def run(g: int) -> None:
            m = managers[g]
            for _ in range(2):
                m.start_quorum()
                GradientAverager(m, bucket_bytes=BUCKET).allreduce([torch.ones(100)])
                assert m.should_commit()

        _run_threads([lambda g=g: run(g) for g in range(2)])
    finally:
        for m in managers:
            m.shutdown()
        lh.shutdown()
    assert torch.equal(weights[0], weights[1])
    streams = [port_report.read_events([p]) for p in paths]
    healer = next(g for g in range(2) if any(e["event"] == "heal_fetched" for e in streams[g]))
    donor = 1 - healer
    heal = {e["event"]: e for e in streams[healer] if e["event"].startswith("heal_")}
    assert heal["heal_start"]["n_donors"] == 1
    assert heal["heal_fetched"]["bytes"] == 4000 and heal["heal_fetched"]["fetch_s"] >= 0
    span = next(e for e in streams[healer] if e["event"] == "span" and e["phase"] == "heal")
    assert span["bytes"] == 4000 and span["duration_ms"] >= heal["heal_fetched"]["fetch_s"]
    snap = next(e for e in streams[donor] if e["event"] == "span" and e["phase"] == "snapshot")
    assert snap["bytes"] == 4000 and snap["step"] == 0
    for evs in streams:
        # Every span lands in one step_summary.
        spans: Dict[str, float] = {}
        summed: Dict[str, float] = {}
        for e in evs:
            if e["event"] == "span":
                spans[e["phase"]] = spans.get(e["phase"], 0.0) + e["duration_ms"]
            if e["event"] == "step_summary":
                for k, v in e["phases"].items():
                    summed[k] = summed.get(k, 0.0) + v
        assert set(spans) == set(summed)
        for k in spans:
            assert summed[k] == pytest.approx(spans[k], abs=0.01), k
        assert [e["committed"] for e in evs if e["event"] == "commit"] == [True, True]


def test_set_status_feeds_heartbeats() -> None:
    """The port twin of the JAX package's set_status test: (step, state)
    and the busy-time EWMA ride the next heartbeat into /status.json."""
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=1,
                                  join_timeout_ms=200, quorum_tick_ms=20)
    srv = None
    try:
        srv = _native.ManagerServer(replica_id="g0:uuid1", lighthouse_addr=lh.address(),
                                    bind=f"{HOST}:0", heartbeat_interval_ms=25)
        srv.set_status(7, "step", 123.0, 120.0)
        url = f"{lh.http_address()}/status.json"
        st = _poll(lambda: json.loads(_get(url)),
                   lambda st: st["replica_step"].get("g0:uuid1") == 7)
        assert st["replica_step"]["g0:uuid1"] == 7 and st["replica_state"]["g0:uuid1"] == "step"
        assert st["replica_step_time_ms"]["g0:uuid1"] == 123
        srv.set_status(8, "heal")
        st = _poll(lambda: json.loads(_get(url)),
                   lambda st: st["replica_step"].get("g0:uuid1") == 8)
        assert st["replica_state"]["g0:uuid1"] == "heal"
        # Step times of 0 keep the previous values.
        assert st["replica_step_time_ms"]["g0:uuid1"] == 123
    finally:
        if srv is not None:
            srv.shutdown()
        lh.shutdown()


def test_set_ledger_feeds_goodput_json() -> None:
    lh = _native.LighthouseServer(bind=f"{HOST}:0", http_bind=f"{HOST}:0", min_replicas=1,
                                  join_timeout_ms=200, quorum_tick_ms=20)
    srv = None
    try:
        srv = _native.ManagerServer(replica_id="g0:led", lighthouse_addr=lh.address(),
                                    bind=f"{HOST}:0", heartbeat_interval_ms=25)
        srv.set_status(5, "step")
        lost = [0.0] * len(LOST_CAUSES)
        lost[LOST_CAUSES.index("heal")] = 2.0
        lost[LOST_CAUSES.index("stall")] = 1.0
        srv.set_ledger(0.7, 7.0, lost)
        doc = _poll(lambda: json.loads(_get(f"{lh.http_address()}/goodput.json")),
                    lambda doc: bool(doc.get("per_replica")))
        assert doc["per_replica"]["g0:led"]["goodput_ratio"] == pytest.approx(0.7)
        assert doc["per_replica"]["g0:led"]["lost_seconds"]["heal"] == 2.0
        assert doc["per_replica"]["g0:led"]["lost_seconds"]["stall"] == 1.0
        assert doc["compute_seconds"] == pytest.approx(7.0)
        text = _get(f"{lh.http_address()}/metrics")
        assert 'tpuft_replica_goodput_ratio{replica="g0:led"} 0.7' in text
    finally:
        if srv is not None:
            srv.shutdown()
        lh.shutdown()
