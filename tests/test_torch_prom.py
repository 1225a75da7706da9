"""The port's worker ``/metrics`` endpoint against the JAX package's.

- ``bucketize``, ``render_histogram_counts`` and ``render_histogram``
  give the JAX helpers' counts and text on seeded observations.
- ``WorkerMetrics.render_prometheus``: the JAX text for the same series
  and sections; a provider or a section that raises leaves the scrape
  alive.
- ``serve``: port 0 on a v4 loopback bind, scraped over HTTP; the
  deprecated ``TPUFT_SEMISYNC_METRICS_PORT`` alias serves with one warning
  a process; unset is off.
- The Manager's series provider and hop histograms on the same stubbed
  state as the JAX Manager's: equal series (names, kinds, help, labels,
  values) and equal text; the histograms stay monotonic over a sliding
  hop ring, split by lane and rolled up by tier (twins of
  tests/test_ledger.py's); every family is documented in docs/wire.md.
- A real port Manager serves the endpoint, with monotonic counters across
  its ring's reconfigure; the semi-sync plane's section folds into it, on
  the worker knob and on the legacy alias, with no second port bound.

Every comparison is exact.
"""

from __future__ import annotations

import json
import logging
import os
import re
import socket
import threading
import time
import urllib.request
from datetime import timedelta
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.checkpointing import HTTPTransport
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.futures import completed_future
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.obs import prom
from torchft_tpu_torch.obs.ledger import StepLedger
from torchft_tpu_torch.obs.spans import StepTimeStats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = "127.0.0.1"


@pytest.fixture(scope="module")
def ref():
    return SimpleNamespace(prom=import_reference("torchft_tpu.obs.prom"),
                           manager=import_reference("torchft_tpu.manager"),
                           ledger=import_reference("torchft_tpu.obs.ledger"),
                           spans=import_reference("torchft_tpu.obs.spans"))


def _scrape(port: int) -> str:
    with urllib.request.urlopen(f"http://{HOST}:{port}/metrics", timeout=10) as resp:
        return resp.read().decode()


def _samples(text: str) -> dict:
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


# -- the histogram helpers --------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bounds", ["latency", "bytes"])
def test_histogram_helpers_equal_the_jax_ones(ref, seed, bounds) -> None:
    rng = np.random.default_rng(seed)
    if bounds == "latency":
        b, port_b = ref.prom.HOP_LATENCY_BOUNDS, prom.HOP_LATENCY_BOUNDS
        values = list(10.0 ** rng.uniform(-5, 1.5, size=200))
    else:
        b, port_b = ref.prom.HOP_BYTES_BOUNDS, prom.HOP_BYTES_BOUNDS
        values = [float(v) for v in 2.0 ** rng.integers(6, 30, size=200)]
    values += list(b[:3])  # the bounds themselves land in their own bucket
    assert port_b == b
    counts, total = prom.bucketize(port_b, values)
    assert (counts, total) == ref.prom.bucketize(b, values)
    # Accumulating into an existing list, as the monotonic histograms do.
    more = values[:50]
    assert prom.bucketize(port_b, more, list(counts)) == ref.prom.bucketize(b, more, list(counts))
    series = [((("tier", "0"), ("lane", str(k))), counts, total) for k in range(2)]
    assert (prom.render_histogram_counts("tpuft_x", "help", port_b, series)
            == ref.prom.render_histogram_counts("tpuft_x", "help", b, series))
    raw = [((("tier", "0"),), values), ((), values[:7])]
    assert (prom.render_histogram("tpuft_y", "h", port_b, raw)
            == ref.prom.render_histogram("tpuft_y", "h", b, raw))


# -- WorkerMetrics ---------------------------------------------------------------


def _series(seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [
        ("tpuft_worker_step", "gauge", "current training step", (), int(rng.integers(0, 1000))),
        ("tpuft_worker_d2h_bytes_total", "counter", "d2h", (), int(rng.integers(0, 1 << 40))),
        ("tpuft_worker_lane_sent_bytes_total", "counter", "sent", (("tier", "flat"),),
         int(rng.integers(0, 1 << 40))),
        ("tpuft_worker_lane_sent_bytes_total", "counter", "sent", (("tier", "x\"y\\z"),),
         float(rng.random())),
    ]


@pytest.mark.parametrize("replica_id", ["", "3:abc"])
def test_worker_metrics_text_equals_the_jax_exposition(ref, replica_id) -> None:
    series = _series(5)
    sections = [lambda: "# extra section\nfoo 1\n", lambda: ""]
    port = prom.WorkerMetrics(replica_id=replica_id, provider=lambda: series)
    jax = ref.prom.WorkerMetrics(replica_id=replica_id, provider=lambda: series)
    for s in sections:
        port.add_section(s)
        jax.add_section(s)
    assert port.render_prometheus() == jax.render_prometheus()
    assert prom.WorkerMetrics().render_prometheus() == ref.prom.WorkerMetrics().render_prometheus()
    assert not port.serving and port.port is None


def test_a_raising_provider_or_section_leaves_the_scrape_alive(ref) -> None:
    def boom():
        raise RuntimeError("provider failed")

    port = prom.WorkerMetrics(replica_id="g", provider=boom)
    jax = ref.prom.WorkerMetrics(replica_id="g", provider=boom)
    for m in (port, jax):
        m.add_section(boom)
        m.add_section(lambda: "ok 1\n")
    assert port.render_prometheus() == jax.render_prometheus() == "ok 1\n"
    got = port.serve(port=0, bind=HOST)
    try:
        assert got and port.serving and port.port == got
        assert _scrape(got) == "ok 1\n"
    finally:
        port.close()
    assert not port.serving


def test_serve_on_port_zero_and_the_env_knobs(monkeypatch) -> None:
    for var in ("TPUFT_WORKER_METRICS_PORT", "TPUFT_SEMISYNC_METRICS_PORT",
                "TPUFT_WORKER_METRICS_BIND", "TPUFT_SEMISYNC_METRICS_BIND"):
        monkeypatch.delenv(var, raising=False)
    m = prom.WorkerMetrics(replica_id="0:u", provider=lambda: _series(1))
    assert m.serve() is None and not m.serving  # unset: off
    monkeypatch.setenv("TPUFT_WORKER_METRICS_PORT", "not-a-port")
    assert m.serve() is None
    monkeypatch.setenv("TPUFT_WORKER_METRICS_PORT", "0")
    monkeypatch.setenv("TPUFT_WORKER_METRICS_BIND", HOST)
    got = m.serve()
    try:
        assert got and m.port == got
        assert _scrape(got) == m.render_prometheus()
        assert 'tpuft_worker_step{replica="0:u"}' in _scrape(got)
    finally:
        m.close()


def test_legacy_alias_serves_with_one_warning(monkeypatch, caplog) -> None:
    monkeypatch.delenv("TPUFT_WORKER_METRICS_PORT", raising=False)
    monkeypatch.delenv("TPUFT_WORKER_METRICS_BIND", raising=False)
    monkeypatch.setenv("TPUFT_SEMISYNC_METRICS_PORT", "0")
    monkeypatch.setenv("TPUFT_SEMISYNC_METRICS_BIND", HOST)
    monkeypatch.setattr(prom, "_alias_warned", False)
    servers = [prom.WorkerMetrics(provider=lambda: _series(2)) for _ in range(2)]
    try:
        with caplog.at_level(logging.WARNING, logger="torchft_tpu_torch.obs.prom"):
            ports = [m.serve() for m in servers]
        assert all(ports) and ports[0] != ports[1]
        warned = [r for r in caplog.records if "TPUFT_SEMISYNC_METRICS_PORT is deprecated"
                  in r.getMessage()]
        assert len(warned) == 1
        assert _scrape(ports[1]) == servers[1].render_prometheus()
    finally:
        for m in servers:
            m.close()


# -- the Manager's provider and hop histograms on stubbed state -------------------


def _stub(manager_cls, stats_cls, ledger_cls, lt, ewma, hop_window):
    stats = stats_cls()
    for v in (120.0, 80.0, 95.5, 101.25):
        stats.observe(v)
    ledger = ledger_cls()
    for step in range(1, 4):
        ledger.observe_step(step, 0.2 * step, {"quorum": 3.0, "allreduce_merge": 40.0 * step,
                                               "heal": 7.0 if step == 2 else 0.0},
                            committed=True)
    ledger.observe_step(4, 0.4, {"quorum": 1.0}, committed=False)
    return SimpleNamespace(
        _step=17, _step_stats=stats, _ar_lock=threading.Lock(), _d2h_bytes_total=123456789,
        _h2d_bytes_total=98765, _link_ewma=dict(ewma), _ledger=ledger,
        _collective=SimpleNamespace(lane_totals=lambda: lt, hop_records=lambda: list(hop_window)),
        _replica_id="g0:stub", _hop_hist={}, _hop_hist_last_ts=0.0,
        _hop_hist_lock=threading.Lock())


_LANE_TOTALS = {
    "reconfigures": 3, "sent_bytes": 300, "recv_bytes": 290,
    "tiers": {"flat": {"sent_bytes": 200, "recv_bytes": 190},
              "inter": {"sent_bytes": 100, "recv_bytes": 100}},
    "hops": {"flat": {"hops": 12, "send_block_s": 0.123456789, "recv_wait_s": 1.5,
                      "combine_s": 0.25, "shape_s": 0.0},
             "inter": {"hops": 4, "send_block_s": 0.0, "recv_wait_s": 0.5,
                       "combine_s": 0.125}},
}


def _hops(first: int, n: int, lanes: int = 2) -> list:
    rng = np.random.default_rng(first)
    out = []
    for i in range(first, first + n):
        rec = {"ts": 100.0 + i, "tier": i % 2, "send_s": float(rng.random() * 1e-3),
               "recv_s": float(rng.random() * 1e-2), "comb_s": float(rng.random() * 1e-4),
               "nbytes": int(rng.integers(512, 1 << 24))}
        if i % 5:
            rec["lane"] = (i // 2) % lanes  # every fifth record predates the lane field
        out.append(rec)
    return out


@pytest.mark.parametrize("case", ["full", "no_link_no_ledger", "no_lane_totals"])
def test_manager_snapshot_equals_the_jax_managers(ref, case) -> None:
    lt = None if case == "no_lane_totals" else _LANE_TOTALS
    ewma = {} if case == "no_link_no_ledger" else {"recv_gbps": 1.234567, "send_gbps": 2.5,
                                                   "rtt_ms": 0.98765}
    port = _stub(Manager, StepTimeStats, StepLedger, lt, ewma, [])
    jax = _stub(ref.manager.Manager, ref.spans.StepTimeStats, ref.ledger.StepLedger, lt, ewma,
                [])
    if case == "no_link_no_ledger":
        port._ledger, jax._ledger = StepLedger(), ref.ledger.StepLedger()
    got = Manager._worker_metrics_snapshot(port)
    want = ref.manager.Manager._worker_metrics_snapshot(jax)
    assert got == want
    names = {s[0] for s in got}
    assert ("tpuft_worker_lane_sent_bytes_total" in names) == (lt is not None)
    assert ("tpuft_link_send_gbps" in names) == bool(ewma)
    # Rendered through each package's endpoint, the text is the same too.
    assert (prom.WorkerMetrics("g0:stub", lambda: got).render_prometheus()
            == ref.prom.WorkerMetrics("g0:stub", lambda: want).render_prometheus())


def test_hop_histograms_monotonic_over_a_sliding_ring(ref) -> None:
    """Twin of tests/test_ledger.py's: scrape 2 sees records 0-9 replaced
    by 5-14 and the exposed ``_count`` only grows; an unchanged ring adds
    nothing.  Every scrape's text equals the JAX Manager's."""
    window = [{"ts": 100.0 + i, "tier": 0, "send_s": 0.001, "recv_s": 0.002, "comb_s": 0.0005,
               "nbytes": 4096} for i in range(10)]
    port = _stub(Manager, StepTimeStats, StepLedger, None, {}, [])
    jax = _stub(ref.manager.Manager, ref.spans.StepTimeStats, ref.ledger.StepLedger, None, {},
                [])
    for fake in (port, jax):
        fake._collective = SimpleNamespace(hop_records=lambda: list(window))

    def count_of(text: str) -> int:
        m = re.search(r'tpuft_worker_hop_latency_seconds_count\{[^}]*tier="0"\} (\d+)', text)
        assert m, text
        return int(m.group(1))

    texts = []
    for slide in (0, 5, 5):
        window[:] = [dict(r, ts=r["ts"] + slide) for r in window]
        text = Manager._render_hop_histograms(port)
        assert text == ref.manager.Manager._render_hop_histograms(jax)
        texts.append(count_of(text))
    assert texts == [10, 15, 20]
    assert count_of(Manager._render_hop_histograms(port)) == 20  # unchanged ring


def test_hop_histograms_lane_split_and_tier_rollup(ref) -> None:
    """Twin of tests/test_ledger.py's: ``tpuft_hop_bytes`` has one series a
    (tier, lane), the tier families sum their lanes, a record without a
    lane folds into lane 0; on seeded records over two tiers the text
    equals the JAX Manager's."""
    recs = _hops(0, 40)
    port = _stub(Manager, StepTimeStats, StepLedger, None, {}, recs)
    jax = _stub(ref.manager.Manager, ref.spans.StepTimeStats, ref.ledger.StepLedger, None, {},
                recs)
    text = Manager._render_hop_histograms(port)
    assert text == ref.manager.Manager._render_hop_histograms(jax)
    samples = _samples(text)
    for tier in (0, 1):
        lanes = [samples[f'tpuft_hop_bytes_count{{replica="g0:stub",tier="{tier}",lane="{k}"}}']
                 for k in (0, 1)]
        whole = samples[f'tpuft_worker_hop_wire_bytes_count{{replica="g0:stub",tier="{tier}"}}']
        assert sum(lanes) == whole == sum(1 for r in recs if r["tier"] == tier)
        assert lanes[0] == sum(1 for r in recs if r["tier"] == tier and r.get("lane", 0) == 0)
    assert Manager._render_hop_histograms(_stub(Manager, StepTimeStats, StepLedger, None, {},
                                                [])) == ""


def test_every_worker_family_is_documented(ref) -> None:
    """Twin of tests/test_ledger.py's pinned-gauges test for the worker
    endpoint: every family the port renders on a full stub is one the JAX
    Manager renders and docs/wire.md documents."""
    port = _stub(Manager, StepTimeStats, StepLedger, _LANE_TOTALS,
                 {"recv_gbps": 1.0, "send_gbps": 1.0, "rtt_ms": 1.0}, _hops(3, 12))
    text = (prom.WorkerMetrics("g0:stub", lambda: Manager._worker_metrics_snapshot(port))
            .render_prometheus() + Manager._render_hop_histograms(port))
    families = set(re.findall(r"^# TYPE (\S+) ", text, flags=re.M))
    assert len(families) == 21
    wire_md = open(os.path.join(REPO, "docs", "wire.md")).read()
    jax_src = open(os.path.join(REPO, "torchft_tpu", "manager.py")).read()
    for name in families:
        assert f"`{name}" in wire_md, name
        assert f'"{name}"' in jax_src, name


# -- a real Manager's endpoint ------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _manager(lh, rid: str) -> Manager:
    timeout = timedelta(seconds=30)
    return Manager(collective=TCPCollective(timeout=30.0, host=HOST), load_state_dict=lambda sd: None,
                   state_dict=lambda: {}, min_replica_size=1, use_async_quorum=False,
                   timeout=timeout, quorum_timeout=timeout, rank=0, world_size=1, replica_id=rid,
                   lighthouse_addr=lh.address(), store_addr=HOST, manager_bind=f"{HOST}:0",
                   checkpoint_transport=HTTPTransport(timeout=30.0, host=HOST))


def test_manager_serves_monotonic_counters_across_reconfigures(monkeypatch, tmp_path) -> None:
    """Two port Managers on one lighthouse: three merged steps; group 1
    leaves (shut down and evicted) and group 0 steps alone, its ring
    reconfigured to one rank; a new incarnation of group 1 joins (both
    reconfigure, it heals) and both step merged again.  Every scrape of an
    endpoint has its counters and histogram counts at least at the last
    scrape's, lane totals equal to ``lane_totals()`` read at the scrape, and
    group 0's reconfigures counter grows; shutdown closes the port and dumps
    the ring's hop timeline under ``TPUFT_HOP_DUMP_DIR`` as the JAX Manager
    does (``hops_<replica id>.json``, which incident bundles collect)."""
    monkeypatch.setenv("TPUFT_HOP_DUMP_DIR", str(tmp_path))
    monkeypatch.setenv("TPUFT_WORKER_METRICS_PORT", "0")
    monkeypatch.setenv("TPUFT_WORKER_METRICS_BIND", HOST)
    monkeypatch.setenv("TPUFT_HOP_SAMPLE", "1")
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1, join_timeout_ms=2000)
    managers = {0: _manager(lh, "prom0"), 1: _manager(lh, "prom1")}
    everyone = list(managers.values())
    scrapes: dict = {}
    ports: list = []
    errors: list = []

    def steps(m: Manager, n: int, delay: float) -> None:
        try:
            time.sleep(delay)
            for _ in range(n):
                m.start_quorum()
                m.note_d2h(1000)
                m.note_h2d(10)
                m.allreduce(torch.full((4096,), 1.0)).result()
                m.should_commit()
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    def scrape(m: Manager) -> dict:
        assert m.worker_metrics.serving
        ports.append(m.worker_metrics.port)
        s = _samples(_scrape(m.worker_metrics.port))
        lt = m.collective().lane_totals()
        for tier, t in lt["tiers"].items():
            lab = f'{{replica="{m.replica_id()}",tier="{tier}"}}'
            assert s[f"tpuft_worker_lane_sent_bytes_total{lab}"] == t["sent_bytes"]
            assert s[f"tpuft_worker_lane_recv_bytes_total{lab}"] == t["recv_bytes"]
            assert s[f"tpuft_worker_hops_total{lab}"] == lt["hops"][tier]["hops"]
        for key, v in scrapes.get(m, [{}])[-1].items():
            if key.split("{")[0].endswith(("_total", "_count", "_sum", "_bucket")):
                assert s.get(key, 0.0) >= v, (m.replica_id(), key, v, s.get(key))
        scrapes.setdefault(m, []).append(s)
        return s

    def phase(plan) -> None:
        ts = [threading.Thread(target=steps, args=a) for a in plan]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not errors and not any(t.is_alive() for t in ts), errors
        for m, _, _ in plan:
            scrape(m)

    try:
        time.sleep(0.5)  # both groups' heartbeats reach the lighthouse
        # Group 1 asks for each merged phase's first quorum first, so the
        # lighthouse waits for group 0 instead of forming a quorum of the
        # members already present.
        phase([(managers[1], 3, 0.0), (managers[0], 3, 0.5)])
        managers[1].shutdown()
        lh.evict("prom1")
        phase([(managers[0], 2, 0.0)])
        managers[1] = _manager(lh, "prom1")
        everyone.append(managers[1])
        time.sleep(0.5)
        phase([(managers[1], 3, 0.0), (managers[0], 3, 0.5)])
        g0 = scrapes[managers[0]]
        key = f'tpuft_worker_reconfigures_total{{replica="{managers[0].replica_id()}"}}'
        assert len(g0) == 3 and g0[0].get(key, 0.0) < g0[1][key] <= g0[2][key]
        assert any(k.startswith("tpuft_worker_hop_latency_seconds_count") and v > 0
                   for k, v in g0[-1].items())
        assert managers[0].current_step() == managers[1].current_step() == 8
    finally:
        for m in everyone:
            m.shutdown()
        lh.shutdown()
    for p in ports:
        with pytest.raises(OSError):
            _scrape(p)
    rid = managers[0].replica_id()
    with open(tmp_path / f"hops_{rid.replace(':', '_')}.json") as f:
        dump = json.load(f)
    assert dump["replica_id"] == rid and dump["records"]
    assert len(list(tmp_path.glob("hops_prom1_*.json"))) == 2  # both incarnations


class _StandIn:
    """A one-group manager serving a port ``WorkerMetrics``."""

    _use_async_quorum = False
    timeout = timedelta(seconds=30)

    def __init__(self, worker_metrics) -> None:
        self.worker_metrics = worker_metrics
        coll = type("Coll", (), {"wire_codecs": ("int8", "int4")})()
        self.collective = lambda: coll
        from torchft_tpu_torch.metrics import MetricsLogger
        from torchft_tpu_torch.obs.spans import SpanTracker

        self.metrics = MetricsLogger(None)
        self.spans = SpanTracker(self.metrics)

    def replica_id(self) -> str:
        return "standin"

    def register_state_dict_fn(self, key, load, save) -> None:
        pass

    def allreduce(self, payload, **kwargs):
        return completed_future(payload)


def _diloco(manager):
    from torchft_tpu_torch.semisync import StreamingDiLoCo, outer

    params = [torch.zeros(8), torch.ones(4)]
    return StreamingDiLoCo(manager, lambda: params, lambda src: None, outer.sgd(0.7),
                           sync_every=2, codec="int8", stream=False)


def test_diloco_section_folds_into_the_worker_endpoint(monkeypatch) -> None:
    monkeypatch.setenv("TPUFT_SEMISYNC_METRICS_PORT", str(_free_port()))
    wm = prom.WorkerMetrics(replica_id="standin")
    port = wm.serve(port=0, bind=HOST)
    try:
        algo = _diloco(_StandIn(wm))
        try:
            text = _scrape(port)
            assert "tpuft_semisync_" in text
            assert algo.metrics._server is None  # no second port
        finally:
            algo.__exit__(None, None, None)
    finally:
        wm.close()


def test_manager_takes_the_legacy_port_and_diloco_does_not_bind_it(monkeypatch) -> None:
    """Under the deprecated ``TPUFT_SEMISYNC_METRICS_PORT`` the Manager's
    endpoint takes the port; DiLoCo folds its section in instead of
    binding it a second time."""
    legacy = _free_port()
    monkeypatch.delenv("TPUFT_WORKER_METRICS_PORT", raising=False)
    monkeypatch.setenv("TPUFT_SEMISYNC_METRICS_PORT", str(legacy))
    monkeypatch.setenv("TPUFT_SEMISYNC_METRICS_BIND", HOST)
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1, join_timeout_ms=100)
    m = _manager(lh, "legacy")
    try:
        assert m.worker_metrics.port == legacy
        algo = _diloco(m)
        try:
            text = _scrape(legacy)
            assert "tpuft_semisync_" in text and "tpuft_worker_step" in text
            assert algo.metrics._server is None
        finally:
            algo.__exit__(None, None, None)
    finally:
        m.shutdown()
        lh.shutdown()
