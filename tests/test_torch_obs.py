"""The port's observability plane against the JAX package's.

- Registries: the event, phase, cause and flight-event registries equal
  the JAX package's, and every ``emit("name")`` call site of the port (and
  of ``chip_smoke.py``) names a registered event.
- Producers: the same calls on a JAX and a port ``MetricsLogger``,
  ``SpanTracker``, ``StepTimeStats``, ``StepLedger`` and ``HopRecorder``
  give equal records, key for key (``ts``, ``t_mono`` and durations
  aside), and ledger cause vectors equal within 1e-9; inputs are drawn
  from a seeded numpy generator.
- Consumers: ``obs.report``'s and ``obs.trace``'s functions return exactly
  the JAX package's results on the JAX package's own fixtures (its
  synthetic worker, flight and hop streams, the bench dead-window fixture,
  a stream with ledger vectors, seeded data-plane summaries, a stream with
  corrupt lines), and so do the report CLIs' ``--json`` outputs.
- Hops: a port ring on each engine keeps records with exactly the JAX
  hop-record keys and aggregates that count its hops; ``TPUFT_HOP_SAMPLE=0``
  keeps the aggregates and drops the timeline; ``lane_totals`` never goes
  backwards across a reconfigure; under ring2d ``lane_stats()`` has the
  JAX collective's keys, ``tiers`` and per-tier hops; a shaped link's
  sleep is ``shape_s`` on either engine.
- Profile: ``tools/profile_step`` parses a Chrome trace in
  ``torch.profiler``'s layout, refuses one without device events, and
  reports a live CPU capture's device part as absent.
- Lint: ``tools/metrics_lint`` exits 0 (every family the port's
  lighthouse and worker endpoint export is documented), and its family set
  equals the JAX lint's (``tools/metrics_lint.py``), computed here.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torch_port_ref import REPO, import_reference
from torchft_tpu_torch import collectives as port_collectives
from torchft_tpu_torch import metrics as port_metrics
from torchft_tpu_torch.obs import flight as port_flight
from torchft_tpu_torch.obs import ledger as port_ledger
from torchft_tpu_torch.obs import report as port_report
from torchft_tpu_torch.obs import spans as port_spans
from torchft_tpu_torch.obs import trace as port_trace
from torchft_tpu_torch.tools import profile_step

VOLATILE = {"ts", "t_mono", "duration_ms", "accounted_ms"}


@pytest.fixture(scope="module")
def ref():
    return {name: import_reference(f"torchft_tpu.{name}")
            for name in ("metrics", "obs.spans", "obs.flight", "obs.ledger", "obs.report",
                         "obs.trace", "collectives")}


def _read(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def _stable(rec: dict) -> dict:
    """A record without its clock fields and durations."""
    out = {k: v for k, v in rec.items() if k not in VOLATILE}
    if isinstance(out.get("phases"), dict):
        out["phases"] = sorted(out["phases"])
    return out


# -- registries ----------------------------------------------------------------


@pytest.mark.parametrize("module, name", [
    ("metrics", "EVENTS"),
    ("metrics", "SCHEMA_VERSION"),
    ("metrics", "METRICS_PATH_ENV"),
    ("obs.spans", "PHASES"),
    ("obs.spans", "OVERLAPPED_PHASES"),
    ("obs.ledger", "CAUSES"),
    ("obs.ledger", "LOST_CAUSES"),
    ("obs.flight", "FLIGHT_EVENTS"),
    ("collectives", "HOP_RECORD_FIELDS"),
    ("collectives", "TPUFT_HOP_SAMPLE_ENV"),
    ("collectives", "TPUFT_HOP_RING_ENV"),
    ("collectives", "_HOP_RING_DEFAULT"),
])
def test_registry_equals_the_jax_packages(ref, module, name) -> None:
    port = {"metrics": port_metrics, "obs.spans": port_spans, "obs.ledger": port_ledger,
            "obs.flight": port_flight, "collectives": port_collectives}[module]
    assert getattr(port, name) == getattr(ref[module], name)


def test_every_port_emit_call_site_is_registered() -> None:
    """The port twin of the JAX package's registry check: every
    ``.emit("name", ...)`` in the port and in chip_smoke.py is in EVENTS."""
    pat = re.compile(r"\.emit\(\s*\n?\s*\"([a-zA-Z0-9_]+)\"")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO, "torchft_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    emitted = {}
    for f in files:
        with open(f, encoding="utf-8") as fh:
            for name in pat.findall(fh.read()):
                emitted.setdefault(name, []).append(os.path.relpath(f, REPO))
    assert {"quorum", "reconfigure", "membership_change", "heal_start", "heal_fetched", "error",
            "commit", "span", "step_summary", "fault"} <= set(emitted)
    unregistered = {n: fs for n, fs in emitted.items() if n not in port_metrics.EVENTS}
    assert not unregistered, unregistered


# -- producers -----------------------------------------------------------------


def _drive_producers(metrics_mod, spans_mod, path: str, rng_seed: int) -> None:
    """The same calls, from one seeded generator, on one package's logger
    and span tracker."""
    rng = np.random.default_rng(rng_seed)
    log = metrics_mod.MetricsLogger(path, replica_id="3:abc")
    tracker = spans_mod.SpanTracker(log, slice_gen=2)
    for step in range(4):
        log.emit("quorum", step=step, quorum_id=int(rng.integers(1, 9)), heal=bool(step == 1))
        for phase in ("quorum", "allreduce_d2h", "allreduce_merge", "allreduce_h2d",
                      "commit_vote", "snapshot"):
            with tracker.span(phase, step=step, bytes=int(rng.integers(0, 1 << 20))):
                pass
        if step == 2:
            try:
                with tracker.span("heal", step=step, src_rank=0):
                    raise RuntimeError("fetch failed")
            except RuntimeError:
                pass
        log.emit("unknown_event", step=step)  # flagged unregistered, still written
        tracker.step_summary(step, committed=step != 3, step_wall_ms=float(rng.random()))
    log.close()


def test_logger_and_span_tracker_write_the_jax_records(ref, tmp_path) -> None:
    jax_path, port_path = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    _drive_producers(ref["metrics"], ref["obs.spans"], jax_path, 7)
    _drive_producers(port_metrics, port_spans, port_path, 7)
    jax_recs, port_recs = _read(jax_path), _read(port_path)
    assert len(jax_recs) == len(port_recs) > 0
    for a, b in zip(jax_recs, port_recs):
        assert set(a) == set(b)
        assert _stable(a) == _stable(b)
    assert any(r.get("unregistered") for r in port_recs)
    assert any(r.get("ok") is False for r in port_recs)


def test_disabled_logger_is_a_no_op(tmp_path) -> None:
    log = port_metrics.MetricsLogger(None)
    assert not log.enabled
    log.emit("commit", step=1)
    tracker = port_spans.SpanTracker(log)
    with tracker.span("quorum", step=0) as sp:
        pass
    assert sp.duration_ms >= 0.0 and tracker.phases_ms() == {"quorum": sp.duration_ms}
    # An unwritable path never raises into the loop either.
    bad = port_metrics.MetricsLogger(str(tmp_path / "no" / "such" / "dir" / "m.jsonl"))
    assert not bad.enabled
    bad.emit("commit", step=1)


def test_recorded_span_is_a_span_record(tmp_path) -> None:
    """The port's ``SpanTracker.record`` (a duration measured elsewhere)
    writes the record ``span()`` writes and accumulates like it."""
    path = str(tmp_path / "m.jsonl")
    tracker = port_spans.SpanTracker(port_metrics.MetricsLogger(path, "0:a"), slice_gen=1)
    tracker.record("snapshot_wait", 5, 12.3456789, note="x")
    with tracker.span("quorum", step=5, note="x"):
        pass
    assert tracker.phases_ms()["snapshot_wait"] == pytest.approx(12.346)
    assert tracker.ft_accounted_ms() >= 12.346
    a, b = _read(path)
    assert a["duration_ms"] == 12.346 and set(a) == set(b)
    assert _stable(a) == {**_stable(b), "phase": "snapshot_wait"}


def test_step_time_stats_equal(ref) -> None:
    rng = np.random.default_rng(11)
    obs = [float(x) for x in rng.exponential(100.0, size=200)] + [-1.0]
    stats = [ref["obs.spans"].StepTimeStats(alpha=0.3, window=32),
             port_spans.StepTimeStats(alpha=0.3, window=32)]
    for ms in obs:
        for s in stats:
            s.observe(ms)
    assert stats[0].snapshot() == stats[1].snapshot()
    assert stats[0].percentile(90) == stats[1].percentile(90)
    assert (stats[0].ewma_ms, stats[0].last_ms) == (stats[1].ewma_ms, stats[1].last_ms)


def _ledger_inputs(seed: int):
    """Seeded ledger observations: phases, cumulative hop aggregates with a
    reset (a reconfigure) midway, failed and committed votes."""
    rng = np.random.default_rng(seed)
    hops = {"hops": 0, "send_block_s": 0.0, "recv_wait_s": 0.0, "combine_s": 0.0,
            "shape_s": 0.0}
    out = []
    for step in range(24):
        if step == 12:
            hops = dict.fromkeys(hops, 0)
        hops = {k: v + (int(rng.integers(1, 40)) if k == "hops" else float(rng.random() * 0.1))
                for k, v in hops.items()}
        phases = {p: float(rng.random() * 50.0) for p in
                  ("quorum", "allreduce_merge", "allreduce_d2h", "allreduce_h2d", "commit_vote",
                   "heal", "configure", "snapshot", "snapshot_wait")}
        lanes = {"lanes": 2, "sent": [1, 2], "recv": [1, 2], "hops": {"flat": dict(hops)}}
        out.append((step, float(0.2 + rng.random()), phases, lanes, step % 7 != 3,
                    step % 5 == 0, float(rng.random() * 20.0) if step % 2 else None))
    return out


def test_step_ledger_cause_vectors_equal(ref) -> None:
    ledgers = [ref["obs.ledger"].StepLedger(), port_ledger.StepLedger()]
    for step, wall, phases, lanes, committed, draining, server in _ledger_inputs(3):
        got = [lg.observe_step(step, wall, phases, lanes=lanes, committed=committed,
                               draining=draining, quorum_server_ms=server) for lg in ledgers]
        if got[0] is None:
            assert got[1] is None
            continue
        assert set(got[0]) == set(got[1]) == set(port_ledger.CAUSES)
        for k in got[0]:
            assert abs(got[0][k] - got[1][k]) <= 1e-9, k
    a, b = (lg.heartbeat_vector() for lg in ledgers)
    assert abs(a[0] - b[0]) <= 1e-9 and abs(a[1] - b[1]) <= 1e-9
    assert np.allclose(a[2], b[2], rtol=0, atol=1e-9)
    assert ledgers[0].snapshot().keys() == ledgers[1].snapshot().keys()
    assert abs(ledgers[0].goodput_ratio() - ledgers[1].goodput_ratio()) <= 1e-9


def test_hop_recorder_matches_the_jax_recorder(ref) -> None:
    rng = np.random.default_rng(5)
    recs = [ref["collectives"].HopRecorder(sample=3, cap=16),
            port_collectives.HopRecorder(sample=3, cap=16)]
    for i in range(60):
        args = (int(rng.integers(0, 2)), int(rng.integers(0, 2)), int(rng.integers(1, 99)),
                float(rng.random()), float(rng.random()), float(rng.random()),
                int(rng.integers(1, 1 << 20)), 1000.0 + i)
        for r in recs:
            r.record(*args)
    assert recs[0].records() == recs[1].records() and len(recs[1].records()) == 16
    for tier in (0, 1, 2):
        assert recs[0].stats(tier) == recs[1].stats(tier)
    for r in recs:
        r.reset_aggregates()
    assert recs[0].stats(0) == recs[1].stats(0) == {"hops": 0, "send_block_s": 0.0,
                                                   "recv_wait_s": 0.0, "combine_s": 0.0}
    assert recs[1].records() == recs[0].records()


@pytest.mark.parametrize("name", ["mint_trace_id", "parse_trace_id"])
def test_trace_ids_equal(ref, name) -> None:
    for gen, rid, step in ((0, "0:a", 0), (3, "smoke_g1:9f6", 1234), (12, "x", 7)):
        tid = ref["obs.flight"].mint_trace_id(gen, rid, step)
        assert port_flight.mint_trace_id(gen, rid, step) == tid
        assert port_flight.parse_trace_id(tid) == ref["obs.flight"].parse_trace_id(tid)
    assert port_flight.parse_trace_id("garbage") == ref["obs.flight"].parse_trace_id("garbage")


# -- consumers -----------------------------------------------------------------


def _bench_fixture() -> list:
    """The JAX package's dead-window bench fixture (tests/test_obs.py)."""
    events = [{"ts": float(t), "replica_id": "0:a", "event": "commit", "committed": True}
              for t in range(1, 41)]
    for t in list(range(1, 11)) + list(range(18, 41)):
        events.append({"ts": float(t), "replica_id": "1:A" if t <= 10 else "1:B",
                       "event": "commit", "committed": True})
    events.append({"ts": 10.5, "replica_id": "fault-injector", "event": "fault",
                   "kind": "kill", "group": "1"})
    return sorted(events, key=lambda e: e["ts"])


def _ledger_stream(ref) -> list:
    """The synthetic worker stream with ledger vectors on its summaries,
    from the JAX ledger."""
    events = ref["obs.trace"].synthetic_stream(n_replicas=2, steps=6)
    ledgers: dict = {}
    for ev in events:
        if ev.get("event") == "step_summary":
            lg = ledgers.setdefault(ev["replica_id"], ref["obs.ledger"].StepLedger())
            causes = lg.observe_step(ev["step"], 1.0, ev.get("phases", {}),
                                     committed=ev.get("committed", True))
            if causes is not None:
                ev["ledger"] = {"causes": {k: round(v, 4) for k, v in causes.items()},
                                "goodput_ratio": lg.goodput_ratio()}
    return events


def _lanes_stream() -> list:
    """Seeded step summaries with the Manager's data-plane fields: payload
    bytes and cumulative ``allreduce_lanes`` snapshots (wire bytes a lane,
    hop aggregates, a 2-D run's tiers) that restart at a reconfigure."""
    rng = np.random.default_rng(21)
    events = []
    for r, rid in enumerate(("0:a0", "1:b1", "1:b2")):
        sent, hops = [0, 0], {"hops": 0, "send_block_s": 0.0, "recv_wait_s": 0.0,
                              "combine_s": 0.0, "shape_s": 0.0}
        for step in range(10):
            if step == 6:
                sent, hops = [0, 0], dict.fromkeys(hops, 0)
            sent = [s + int(rng.integers(1, 1 << 20)) for s in sent]
            hops = {k: v + (int(rng.integers(1, 30)) if k == "hops" else float(rng.random()))
                    for k, v in hops.items()}
            lanes = {"lanes": 2, "topology": "ring2d" if r == 2 else "ring", "engine": "native",
                     "sent": list(sent), "recv": list(sent), "hops": {"flat": dict(hops)}}
            if r == 2:
                lanes["tiers"] = {"row": {"size": 2, "sent": [s // 2 for s in sent],
                                          "recv": [s // 2 for s in sent]}}
            events.append({"ts": 100.0 + step + 0.01 * r, "t_mono": 5.0 + step,
                           "replica_id": rid, "event": "step_summary", "step": step,
                           "committed": True, "phases": {"allreduce_merge": 10.0},
                           "allreduce_bytes": int(rng.integers(1, 1 << 24)),
                           "allreduce_lanes": lanes})
            events.append({"ts": 100.0 + step + 0.01 * r, "replica_id": rid, "event": "commit",
                           "step": step, "committed": True})
    return sorted(events, key=lambda e: e["ts"])


def _fixture(ref, name: str) -> list:
    tr = ref["obs.trace"]
    if name == "lanes":
        return _lanes_stream()
    if name == "worker":
        return tr.synthetic_stream(n_replicas=2, steps=4)
    if name == "worker+flight+hops":
        evs = (tr.synthetic_stream(n_replicas=3, steps=5)
               + tr.synthetic_flight_stream(n_replicas=3, steps=5)
               + tr.synthetic_hop_stream(n_replicas=3, steps=5))
        return sorted(evs, key=lambda e: e["ts"])
    if name == "bench":
        return _bench_fixture()
    return _ledger_stream(ref)


FIXTURES = ["worker", "worker+flight+hops", "bench", "ledger", "lanes"]
CONSUMERS = ["attribute", "deadwindow", "data_plane", "link_attribution", "commit_timelines",
             "fault_times", "ledger_rollup", "crosscheck_goodput", "build_trace",
             "validate_trace"]


def _consume(mods: dict, name: str, events: list):
    report, trace, ledger = mods["report"], mods["trace"], mods["ledger"]
    if name == "deadwindow":
        return report.deadwindow(report.commit_timelines(events), report.fault_times(events))
    if name in ("ledger_rollup", "crosscheck_goodput"):
        return getattr(ledger, name)(events)
    if name == "build_trace":
        return trace.build_trace(events)
    if name == "validate_trace":
        return trace.validate_trace(trace.build_trace(events))
    return getattr(report, name)(events)


@pytest.mark.parametrize("fixture", FIXTURES)
@pytest.mark.parametrize("consumer", CONSUMERS)
def test_consumer_equals_the_jax_packages(ref, fixture, consumer) -> None:
    events = _fixture(ref, fixture)
    jax_mods = {"report": ref["obs.report"], "trace": ref["obs.trace"],
                "ledger": ref["obs.ledger"]}
    port_mods = {"report": port_report, "trace": port_trace, "ledger": port_ledger}
    want = _consume(jax_mods, consumer, json.loads(json.dumps(events)))
    got = _consume(port_mods, consumer, json.loads(json.dumps(events)))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if consumer == "validate_trace":
        assert got == []


def _write_corrupt(path) -> None:
    lines = [json.dumps(e) for e in _bench_fixture()]
    lines.insert(3, '{"ts": 2.5, "event": "commit", "replica_')  # torn record
    lines.insert(7, "[1, 2, 3]")  # not a dict
    lines.insert(9, "garbage")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n" + '{"ts": 99.0, "event"')  # no newline at the end


def test_read_events_on_corrupt_lines_equal(ref, tmp_path) -> None:
    path = str(tmp_path / "corrupt.jsonl")
    _write_corrupt(path)
    missing = str(tmp_path / "missing.jsonl")
    js, ps = {}, {}
    want = ref["obs.report"].read_events([path, missing], stats=js)
    got = port_report.read_events([path, missing], stats=ps)
    assert got == want and ps == js and ps["skipped_lines"] >= 4


@pytest.mark.parametrize("fixture", ["corrupt", "worker+flight+hops"])
def test_report_cli_json_equal(ref, tmp_path, fixture) -> None:
    path = str(tmp_path / "m.jsonl")
    if fixture == "corrupt":
        _write_corrupt(path)
    else:
        with open(path, "w") as f:
            f.writelines(json.dumps(e) + "\n" for e in _fixture(ref, fixture))
    outs = []
    for pkg in ("torchft_tpu", "torchft_tpu_torch"):
        r = subprocess.run([sys.executable, "-m", f"{pkg}.obs.report", path, "--json"],
                           capture_output=True, text=True, timeout=120, cwd=REPO)
        assert r.returncode == 0, r.stderr
        outs.append(json.loads(r.stdout))
    assert outs[0] == outs[1]


def test_trace_export_quick_passes() -> None:
    r = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.tools.trace_export", "--quick",
                        "-o", os.devnull], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0, r.stderr
    summary = json.loads(r.stdout)
    assert summary["ok"] and summary["hop_slices"] > 0 and summary["control_plane_tracks"] > 0


def test_trace_export_quick_incident_bundle_round_trip() -> None:
    """The port's ``--quick`` writes, finalizes and reads back a synthetic
    kill's incident bundle whose verdict names the victim, as the JAX
    tool's does; its summary equals the JAX tool's but for the output path."""
    outs = []
    for cmd in ([sys.executable, "-m", "torchft_tpu_torch.tools.trace_export"],
                [sys.executable, os.path.join(REPO, "tools", "trace_export.py")]):
        r = subprocess.run(cmd + ["--quick", "-o", os.devnull], capture_output=True, text=True,
                           timeout=120, cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cpu"})
        assert r.returncode == 0, r.stderr
        outs.append({k: v for k, v in json.loads(r.stdout).items() if k != "out"})
    assert outs[0]["incident_bundle_ok"] is True
    assert outs[0] == outs[1]


# -- hops ----------------------------------------------------------------------


def _ring_pair(engine: str, sample: str, monkeypatch, rounds: int, reconfigure: bool):
    """Two in-process ranks of a 2-lane port ring on ``engine``; returns
    each rank's (hop records, lane_stats, lane_totals before and after)."""
    from torchft_tpu_torch import _native

    if engine == "native" and not _native.ring_engine_available():
        pytest.fail(f"the native ring engine is unavailable: "
                    f"{_native.ring_engine_unavailable_reason()}")
    monkeypatch.setenv("TPUFT_HOP_SAMPLE", sample)
    store = _native.StoreServer(bind="127.0.0.1:0")
    cols = [port_collectives.TCPCollective(timeout=30.0, lanes=2, engine=engine,
                                           chunk_bytes=4 << 10, host="127.0.0.1")
            for _ in range(2)]
    rng = np.random.default_rng(9)
    data = [rng.standard_normal(12_000).astype(np.float32) for _ in range(2)]
    barrier = threading.Barrier(2)

    def rank(r: int):
        c = cols[r]
        totals = []
        for gen in range(2 if reconfigure else 1):
            c.configure(f"{store.address()}/hops/{gen}", r, 2)
            for _ in range(rounds):
                c.allreduce([data[r]]).wait(timeout=30)
            barrier.wait(timeout=30)
            totals.append(c.lane_totals())
        return c.hop_records(), c.lane_stats(), totals

    try:
        with ThreadPoolExecutor(2) as pool:
            return [f.result(timeout=60) for f in [pool.submit(rank, r) for r in range(2)]]
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()


@pytest.mark.parametrize("engine", ["py", "native"])
@pytest.mark.parametrize("sample", ["1", "0"])
def test_ring_hop_records_and_aggregates(ref, engine, sample, monkeypatch) -> None:
    rounds = 3
    for records, stats, _ in _ring_pair(engine, sample, monkeypatch, rounds, False):
        hops = stats["hops"]["flat"]
        # 2 ranks: one reduce-scatter and one allgather hop a stripe; the
        # 48 KB payload cuts into 2 stripes of 24 KB chunks... per op.
        stripes = port_collectives.TCPCollective(lanes=2, chunk_bytes=4 << 10)._stripe_count(
            24_000)
        assert hops["hops"] == rounds * stripes * 2
        assert set(hops) == {"hops", "send_block_s", "recv_wait_s", "combine_s", "shape_s"}
        assert stats["engine"] == engine and sum(stats["sent"]) > rounds * 48_000
        if sample == "0":
            assert records == []
        else:
            assert len(records) == hops["hops"]
            for rec in records:
                assert tuple(rec) == ref["collectives"].HOP_RECORD_FIELDS
                assert rec["tier"] == 0 and rec["lane"] in (0, 1) and rec["nbytes"] > 0
            assert [r["ts"] for r in records] == sorted(r["ts"] for r in records)


def _ring_world(make, world: int, body):
    """``world`` in-process ranks made by ``make()``, configured on a fresh
    store; each rank's ``body(c, rank)``."""
    from torchft_tpu_torch import _native

    store = _native.StoreServer(bind="127.0.0.1:0")
    cols = [make() for _ in range(world)]

    def rank(r: int):
        cols[r].configure(f"{store.address()}/hops/world", r, world)
        return body(cols[r], r)

    try:
        with ThreadPoolExecutor(world) as pool:
            return [f.result(timeout=60) for f in [pool.submit(rank, r) for r in range(world)]]
    finally:
        for c in cols:
            c.shutdown()
        store.shutdown()


@pytest.mark.parametrize("engine", ["py", "native"])
def test_ring2d_lane_stats_layout_equals_the_jax_collectives(ref, engine, monkeypatch) -> None:
    """Under ring2d ``lane_stats()`` has the JAX collective's keys, its
    ``tiers`` (each tier's size and per-lane counters) and per-tier
    ``hops``, and the hops of each tier count the ring2d pass's hops."""
    monkeypatch.setenv("TPUFT_HOP_SAMPLE", "1")
    rng = np.random.default_rng(41)
    data = [rng.standard_normal(12_000).astype(np.float32) for _ in range(4)]

    def body(c, r):
        c.allreduce([data[r]]).wait(timeout=30)
        return c.lane_stats(), c.hop_records()

    port = _ring_world(lambda: port_collectives.TCPCollective(
        timeout=30.0, lanes=2, engine=engine, chunk_bytes=4 << 10, host="127.0.0.1",
        topology="ring2d"), 4, body)
    jax = _ring_world(lambda: ref["collectives"].TCPCollective(
        timeout=30.0, lanes=2, engine=engine, chunk_bytes=4 << 10, topology="ring2d",
        transport="tcp"), 4, body)
    for (ps, precs), (js, jrecs) in zip(port, jax):
        assert set(ps) == set(js) and ps["topology"] == js["topology"] == "ring2d"
        assert set(ps["tiers"]) == set(js["tiers"]) == {"row", "col"}
        for name in ("row", "col"):
            assert set(ps["tiers"][name]) == set(js["tiers"][name])
            assert ps["tiers"][name]["size"] == js["tiers"][name]["size"] == 2
            assert ps["tiers"][name]["sent"] == js["tiers"][name]["sent"], name
            assert ps["hops"][name]["hops"] == js["hops"][name]["hops"] > 0, name
        assert set(ps["hops"]) == set(js["hops"]) == {"flat", "row", "col"}
        for name in ps["hops"]:
            assert set(ps["hops"][name]) == set(js["hops"][name])
        assert {r["tier"] for r in precs} == {r["tier"] for r in jrecs} == {1, 2}


@pytest.mark.parametrize("engine", ["py", "native"])
def test_shaped_ring_reports_shape_s(engine, monkeypatch) -> None:
    """Under ``TPUFT_SHAPED_LINK`` the pacer's sleep is the flat tier's
    ``shape_s`` on either engine, and it is banked into ``lane_totals``."""
    monkeypatch.setenv("TPUFT_SHAPED_LINK", "200:2")

    def body(c, r):
        c.allreduce([np.ones(50_000, np.float32)]).wait(timeout=30)
        return c.lane_stats()["hops"]["flat"]["shape_s"], c.lane_totals(), c.ring_engine

    for shape_s, totals, ran in _ring_world(lambda: port_collectives.TCPCollective(
            timeout=30.0, lanes=2, engine=engine, host="127.0.0.1"), 2, body):
        assert ran == engine and shape_s > 0.0
        assert totals["hops"]["flat"]["shape_s"] == pytest.approx(shape_s, rel=1e-6)


@pytest.mark.parametrize("engine", ["py", "native"])
def test_lane_totals_monotonic_across_reconfigure(engine, monkeypatch) -> None:
    for records, stats, (first, second) in _ring_pair(engine, "1", monkeypatch, 2, True):
        # The second configuration's counters restarted...
        assert stats["hops"]["flat"]["hops"] == first["hops"]["flat"]["hops"]
        # ...but the totals add the banked first configuration to them.
        assert second["reconfigures"] == 1 and first["reconfigures"] == 0
        for key in ("sent_bytes", "recv_bytes"):
            assert second[key] == 2 * first[key] > 0
        for key in ("hops", "send_block_s", "recv_wait_s", "combine_s"):
            assert second["hops"]["flat"][key] >= first["hops"]["flat"][key]
        assert second["hops"]["flat"]["hops"] == 2 * first["hops"]["flat"]["hops"]
        # The closed configuration's timeline was kept.
        assert len(records) == second["hops"]["flat"]["hops"]


# -- profile ---------------------------------------------------------------------


def _profiler_trace(with_device: bool) -> dict:
    """Two steps in torch.profiler's Chrome-trace layout: per step a CPU op
    and annotation, and on the CUDA stream track two kernels (one
    overlapping the other) and a copy."""
    ev = [{"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "cuda:0"}},
          {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler", "ts": 0.0, "dur": 5000.0,
           "pid": 1, "tid": 1}]
    for step in range(2):
        t = 1000.0 + step * 1000.0
        ev.append({"ph": "X", "cat": "user_annotation", "name": f"profile_step#{step}",
                   "ts": t, "dur": 800.0, "pid": 1, "tid": 1})
        ev.append({"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": t + 10, "dur": 50.0,
                   "pid": 1, "tid": 1})
        if with_device:
            ev += [
                {"ph": "X", "cat": "kernel", "name": "void flash_fwd_kernel<128>(Params)",
                 "ts": t + 100, "dur": 300.0, "pid": 0, "tid": 7},
                {"ph": "X", "cat": "kernel",
                 "name": "void at::native::vectorized_elementwise_kernel<4, Add>(int, Add)",
                 "ts": t + 300, "dur": 200.0, "pid": 0, "tid": 8},
                {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
                 "ts": t + 700, "dur": 200.0, "pid": 0, "tid": 7},
            ]
    return {"traceEvents": ev}


def test_profile_report_of_a_torch_profiler_trace(tmp_path) -> None:
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump(_profiler_trace(True), f)
    rep = profile_step.build_report(path, steps=2)
    assert rep["schema"] == 1 and rep["device_events"] == 6
    # 300 + 200 + 200 us a step; busy = the union [100, 500] + [700, 900].
    assert rep["device_total_ms_per_step"] == pytest.approx(0.7)
    # The window: first annotation's start to the last copy's end (1900 us).
    assert rep["wall_ms_per_step"] == pytest.approx(0.95)
    assert rep["device_busy_share"] == pytest.approx(round(1200.0 / 1900.0, 4))
    assert profile_step.launches_per_step(rep, "flash_fwd_kernel") == 1.0
    classes = {c["op_class"]: c["ms_per_step"] for c in rep["by_class"]}
    assert classes == {"flash_fwd_kernel": 0.3, "vectorized_elementwise_kernel": 0.2,
                       "Memcpy DtoH": 0.2}
    assert [op["name"] for op in rep["ops"]][0].startswith("void flash_fwd_kernel")
    assert profile_step.main(["--trace", path, "--steps", "2", "--json"]) == 0


@pytest.mark.parametrize("name, cls", [
    ("void at::native::vectorized_elementwise_kernel<4, Add>(int, Add)",
     "vectorized_elementwise_kernel"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<at::native::(anonymous "
     "namespace)::OpaqueType<4u>, unsigned int>(int)", "CatArrayBatchedCopy"),
    ("tft::(anonymous namespace)::flash_fwd_kernel(CUtensorMap_st, float*, int)",
     "flash_fwd_kernel"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_TNT", "nvjet_tst"),
    ("Memcpy DtoH (Device -> Pinned)", "Memcpy DtoH"),
    ("fusion.123", "fusion"),
])
def test_op_class_names_the_kernel(name, cls) -> None:
    assert profile_step.op_class(name) == cls


def test_profile_without_device_events_exits_nonzero(tmp_path, capsys) -> None:
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump(_profiler_trace(False), f)
    assert profile_step.main(["--trace", path, "--steps", "2"]) != 0
    assert "no device events" in capsys.readouterr().err
    rep = profile_step.build_report(path, steps=2)
    assert rep["device_total_ms_per_step"] is None and rep["device_busy_share"] is None


def test_live_cpu_capture_reports_the_device_as_absent(tmp_path) -> None:
    from torchft_tpu_torch.models import TransformerConfig

    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=2, n_kv_heads=2,
                            d_ff=64, max_seq=16)
    path = profile_step.capture(str(tmp_path / "cpu.json"), steps=2, device="cpu", cfg=cfg,
                                batch=2, seq=16, warmup=1)
    rep = profile_step.build_report(path, steps=2)
    assert rep["device_events"] == 0 and rep["device_total_ms_per_step"] is None
    assert rep["wall_ms_per_step"] > 0 and "no device events" in rep["device_absent"]


def test_profile_capture_asks_for_the_card_by_default() -> None:
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default capture would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_step.capture(os.devnull, steps=1)


def test_metrics_lint_clean(capsys) -> None:
    from torchft_tpu_torch.tools import metrics_lint

    assert metrics_lint.main([]) == 0
    assert "all documented" in capsys.readouterr().out


def test_metrics_lint_families_equal_jax() -> None:
    """The port's lighthouse and worker families are the JAX lint's scrape,
    family for family."""
    from torchft_tpu_torch.tools import metrics_lint

    import_reference("torchft_tpu._native")
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import metrics_lint as jax_lint
    finally:
        sys.path.pop(0)
    want = jax_lint.lighthouse_families() | jax_lint.worker_families()
    got = metrics_lint.lighthouse_families() | metrics_lint.worker_families()
    assert want and got == want, sorted(got ^ want)
