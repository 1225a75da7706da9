"""The port's incident capture, verdict and watcher against the JAX
package's.

- Bundles: on one synthetic lighthouse feed (a local HTTP server serving
  ``/debug/flight.json``, ``/alerts.json``, ``/goodput.json``,
  ``/status.json``, ``/incident.json``) and the same metrics streams and
  shutdown dumps, ``capture_bundle`` + ``finalize_bundle`` write the JAX
  package's files byte for byte and its manifest, ``load_bundle`` reads
  the same, and ``verdict`` gives the JAX verdict for every trigger reason
  (a kill both ways, a region loss, a straggler, a slow link, a coverage
  shortfall, a goodput dip with and without a culprit, an SLO burn, an
  unknown reason); a repeat trigger for a step appends to its manifest.
- Retention: ``_prune_bundles`` under ``TPUFT_INCIDENT_RETAIN``.
- The watcher, twins of tests/test_slo.py's on the ``fetch``/``clock``
  injectables: the flap guard and its expiry, the poll throttle and the
  seen-id dedup, dry-run against act, never draining the cluster, address
  failover, an address being required; each run through both packages'
  watchers with equal journals (timestamps aside).
- A JAX and a port watcher on one live (port-built) lighthouse with a
  straggler alert and an eviction journal the same decisions.
- ``python -m torchft_tpu_torch.tools.incident`` capture and verdict give
  the JAX ``tools/incident.py``'s verdicts.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.obs import incident as port_incident
from torchft_tpu_torch.obs import trace as port_trace
from torchft_tpu_torch.obs import watcher as port_watcher
from torchft_tpu_torch.obs.ledger import LOST_CAUSES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref():
    return (import_reference("torchft_tpu.obs.incident"),
            import_reference("torchft_tpu.obs.watcher"),
            import_reference("torchft_tpu._native"))


class _Feed:
    """A lighthouse stand-in: GET <path> answers ``docs[path]`` as JSON (404
    where absent)."""

    def __init__(self, docs: dict) -> None:
        self.docs = docs
        feed = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - stdlib API
                doc = feed.docs.get(self.path)
                if doc is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                body = json.dumps(doc).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args) -> None:
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.address = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


_ALERTS = [
    {"id": 1, "kind": "straggler", "active": True, "replica_id": "1:b1", "ratio": 2.5,
     "step_time_ms": 900.0, "raised_ms": 1_700_000_002_000},
    {"id": 2, "kind": "slow_link", "active": True, "replica_id": "0:a0",
     "src_replica_id": "1:b1", "gbps": 0.42, "raised_ms": 1_700_000_002_100},
    {"id": 3, "kind": "ec_coverage", "active": True, "replica_id": "", "coverage": 1,
     "threshold": 2, "raised_ms": 1_700_000_002_200},
    {"id": 4, "kind": "slo_burn", "active": True, "replica_id": "0:a0", "burn_fast": 14.4,
     "burn_slow": 6.1, "dominant_cause": "stall", "charged_seconds": 3.25,
     "raised_ms": 1_700_000_002_300},
]

_TRIGGERS = {
    "kill": {"reason": "replica_stale", "replica_id": "1:b1", "detail": 500.0},
    "evicted": {"reason": "replica_evicted", "replica_id": "1:b1"},
    "region": {"reason": "region_stale", "replica_id": "us-east", "detail": 7000},
    "straggler": {"reason": "alert:straggler", "replica_id": "1:b1", "detail": 2.5},
    "slow_link": {"reason": "alert:slow_link", "replica_id": "0:a0", "detail": 0.42},
    "coverage": {"reason": "alert:ec_coverage", "replica_id": "", "detail": 1},
    "dip_culprit": {"reason": "goodput_floor", "replica_id": "cluster", "detail": 0.61,
                    "culprit_replica": "1:b1", "culprit_region": "us-east",
                    "dominant_cause": "stall", "charged_seconds": 4.5,
                    "delta_by_replica": {"1:b1": 4.5, "0:a0": 0.25}},
    "dip_diffuse": {"reason": "goodput_floor", "replica_id": "cluster", "detail": 0.7},
    "slo_burn": {"reason": "alert:slo_burn", "replica_id": "0:a0", "detail": 14.4,
                 "culprit_replica": "0:a0", "dominant_cause": "stall",
                 "charged_seconds": 3.25},
    "unknown": {"reason": "something_new", "replica_id": "0:a0"},
}


def _streams(workdir: str) -> list:
    """The synthetic two-replica run (spans, hops, a kill fault, a drain)
    plus two membership changes, split into one stream per replica, and a
    manager flight dump and a hop dump beside them.  Returns the paths."""
    events = port_trace.synthetic_stream(n_replicas=2, steps=4)
    events += port_trace.synthetic_hop_stream(n_replicas=2, steps=4)
    for i, (old, new) in enumerate(((2, 1), (1, 2))):
        events.append({"schema": 1, "ts": 1_700_000_002.5 + i, "event": "membership_change",
                       "replica_id": "0:a0", "step": 3 + i, "old_participants": old,
                       "new_participants": new, "joined": ["1:b1"] if new > old else [],
                       "left": ["1:b1"] if new < old else [], "transition_s": 0.125 * (i + 1),
                       "mode": "incremental"})
    events.sort(key=lambda e: e["ts"])
    paths = []
    for r in range(2):
        path = os.path.join(workdir, f"metrics_g{r}.jsonl")
        with open(path, "w") as f:
            for ev in events:
                if str(ev.get("replica_id", "")).startswith(f"{r}:"):
                    f.write(json.dumps(ev) + "\n")
        paths.append(path)
    with open(os.path.join(workdir, "flight_manager_0_a0.json"), "w") as f:
        json.dump({"source": "manager:0:a0", "events": [{"seq": 1, "kind": "rpc"}]}, f)
    with open(os.path.join(workdir, "hops_0_a0.json"), "w") as f:
        json.dump({"replica_id": "0:a0", "records": [{"ts": 1_700_000_001.5, "tier": 0}]}, f)
    return paths


def _docs(trigger: dict) -> dict:
    lost = {c: 0.5 * (i + 1) for i, c in enumerate(LOST_CAUSES)}
    return {
        "/debug/flight.json": {"events": [{"seq": 7, "kind": "quorum_formed",
                                           "detail": "members=[0:a0,1:b1]"}]},
        "/alerts.json": {"alerts": copy.deepcopy(_ALERTS), "active": len(_ALERTS)},
        "/goodput.json": {"goodput_ratio": 0.8, "compute_seconds": 40.0, "lost_seconds": lost},
        "/status.json": {"replicas": ["0:a0", "1:b1"], "quorum_id": 3},
        "/incident.json": {"incidents": [trigger]},
    }


def _bundle_files(bundle: str) -> dict:
    out = {}
    for name in sorted(os.listdir(bundle)):
        with open(os.path.join(bundle, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("case", sorted(_TRIGGERS))
def test_bundle_manifest_and_verdict_equal_the_jax_ones(ref, tmp_path, case) -> None:
    jincident, _, _ = ref
    trigger = {"id": 11, "step": 4, "ts_ms": 1_700_000_002_400, **_TRIGGERS[case]}
    feed = _Feed(_docs(trigger))
    results = {}
    try:
        for name, mod in (("jax", jincident), ("port", port_incident)):
            workdir = str(tmp_path / name)
            os.makedirs(workdir)
            paths = _streams(workdir)
            bundle = mod.capture_bundle(workdir, feed.address, trigger, metrics_paths=paths)
            assert os.path.basename(bundle) == "incident_4"
            manifest = mod.finalize_bundle(bundle, workdir)
            results[name] = (manifest, _bundle_files(bundle), mod.load_bundle(bundle), bundle)
    finally:
        feed.close()
    (jm, jfiles, jload, jb), (pm, pfiles, pload, pb) = results["jax"], results["port"]
    assert pm == jm
    assert pfiles == jfiles
    assert pload == jload
    assert set(pfiles) == {"incident.json", "lighthouse_flight.json", "alerts.json",
                           "goodput.json", "status.json", "spans_tail.jsonl",
                           "flight_manager_0_a0.json", "hops_0_a0.json"}
    # Each package's verdict reads the other's bundle the same.
    assert port_incident.verdict(jb) == jincident.verdict(pb) == pm["verdict"]
    v = pm["verdict"]
    want = {"kill": ("kill", "1"), "evicted": ("kill", "1"), "region": ("region_loss", "us-east"),
            "straggler": ("straggler", "1"), "slow_link": ("slow_link", "1"),
            "coverage": ("redundancy", "cluster"), "dip_culprit": ("goodput_dip", "1"),
            "dip_diffuse": ("goodput_dip", "cluster"), "slo_burn": ("slo_burn", "0"),
            "unknown": ("unknown", None)}[case]
    assert (v["kind"], v["replica"]) == want
    assert [c["step"] for c in v["membership_changes"]] == [3, 4]
    # With the full stream handed in, finalize gives the JAX verdict too.
    events = port_incident.load_bundle(pb)["events"]
    assert (port_incident.finalize_bundle(pb, str(tmp_path / "port"), events=events)["verdict"]
            == jincident.finalize_bundle(jb, str(tmp_path / "jax"), events=events)["verdict"])


def test_a_repeat_trigger_appends_to_its_steps_manifest(ref, tmp_path) -> None:
    jincident, _, _ = ref
    first = {"id": 1, "step": 9, "ts_ms": 1, **_TRIGGERS["kill"]}
    second = {"id": 2, "step": 9, "ts_ms": 2, **_TRIGGERS["evicted"]}
    feed = _Feed(_docs(first))
    try:
        files = []
        for name, mod in (("jax", jincident), ("port", port_incident)):
            workdir = str(tmp_path / name)
            os.makedirs(workdir)
            bundle = mod.capture_bundle(workdir, feed.address, first)
            feed.docs["/status.json"] = {"changed": name}  # first evidence wins
            mod.capture_bundle(workdir, feed.address, second)
            feed.docs["/status.json"] = _docs(first)["/status.json"]
            files.append(_bundle_files(bundle))
            manifest = json.loads(files[-1]["incident.json"])
            assert [t["id"] for t in manifest["incidents"]] == [1, 2]
            assert json.loads(files[-1]["status.json"]) == _docs(first)["/status.json"]
        assert files[0] == files[1]
    finally:
        feed.close()
    with pytest.raises(OSError):
        port_incident.load_bundle(str(tmp_path / "nothing"))


def test_fetch_json_and_the_feed_poller(ref, tmp_path) -> None:
    jincident, _, _ = ref
    feed = _Feed({"/incident.json": {"incidents": [{"id": 1}, {"id": 2}, "junk"]},
                  "/list": [1, 2]})
    try:
        assert port_incident.fetch_json(feed.address, "/list") is None  # not a dict
        assert port_incident.fetch_json(feed.address, "/absent") is None
        host = feed.address[len("http://"):]  # the scheme is optional
        assert (port_incident.fetch_json(host, "/incident.json")
                == jincident.fetch_json(host, "/incident.json"))
        pw, jw = port_incident.IncidentWatcher(feed.address), jincident.IncidentWatcher(feed.address)
        assert pw.poll() == jw.poll() == [{"id": 1}, {"id": 2}]
        assert pw.poll() == jw.poll() == []
        pw.unsee(2)
        jw.unsee(2)
        assert pw.poll() == jw.poll() == [{"id": 2}]
    finally:
        feed.close()
    assert port_incident.fetch_json("http://127.0.0.1:1", "/x", timeout=1.0) is None


def test_incident_retention_prunes_oldest(tmp_path, monkeypatch) -> None:
    """Twin of tests/test_slo.py's retention test."""
    monkeypatch.setenv("TPUFT_INCIDENT_RETAIN", "3")
    for step in (1, 2, 3, 4, 5):
        (tmp_path / f"incident_{step}").mkdir()
        (tmp_path / f"incident_{step}" / "state.json").write_text("{}")
    (tmp_path / "incident_notastep").mkdir()
    (tmp_path / "checkpoints").mkdir()
    pruned = port_incident._prune_bundles(str(tmp_path), keep=str(tmp_path / "incident_5"))
    assert sorted(os.path.basename(p) for p in pruned) == ["incident_1", "incident_2"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "checkpoints", "incident_3", "incident_4", "incident_5", "incident_notastep"]
    monkeypatch.setenv("TPUFT_INCIDENT_RETAIN", "1")
    pruned = port_incident._prune_bundles(str(tmp_path), keep=str(tmp_path / "incident_3"))
    assert sorted(os.path.basename(p) for p in pruned) == ["incident_4", "incident_5"]
    assert (tmp_path / "incident_3").exists()
    monkeypatch.setenv("TPUFT_INCIDENT_RETAIN", "0")
    (tmp_path / "incident_9").mkdir()
    assert port_incident._prune_bundles(str(tmp_path), keep=None) == []
    monkeypatch.setenv("TPUFT_INCIDENT_RETAIN", "garbage")  # the default, 16
    assert port_incident._prune_bundles(str(tmp_path)) == []


# -- the watcher on a synthetic feed (tests/test_slo.py's twins) ---------------------------


class _Clock:
    def __init__(self) -> None:
        self.t = 100.0

    def __call__(self) -> float:
        return self.t


def _feed_fetch(incidents: list):
    def fetch(address, path):
        if path == "/incident.json":
            return {"incidents": list(incidents)}
        if path == "/alerts.json":
            return {"alerts": []}
        return {}
    return fetch


def _incident(rid, reason="alert:straggler", replica="g2:u", **extra) -> dict:
    rec = {"id": rid, "reason": reason, "replica_id": replica, "step": rid, "ts_ms": 1000 + rid,
           "detail": 2.5}
    rec.update(extra)
    return rec


def _both(ref, tmp_path, scenario) -> list:
    """Runs ``scenario(watcher_module, workdir)`` through the JAX and the
    port watcher; asserts equal results and journals (timestamps aside);
    returns the port's result."""
    _, jwatcher, _ = ref
    out = []
    for name, mod in (("jax", jwatcher), ("port", port_watcher)):
        workdir = tmp_path / name
        result = scenario(mod, workdir)
        journal = workdir / "watcher_journal.jsonl"
        lines = ([{k: v for k, v in json.loads(x).items() if k != "ts"}
                  for x in journal.read_text().splitlines()] if journal.exists() else [])
        strip = json.loads(json.dumps(result, default=str), object_hook=lambda d: {
            k: v for k, v in d.items() if k != "ts"})
        out.append((strip, lines))
    assert out[0] == out[1]
    return out[1]


def _mk(mod, workdir, incidents, clock, **kw):
    kw.setdefault("fetch", _feed_fetch(incidents))
    return mod.IncidentWatcher(["http://127.0.0.1:1"], str(workdir), poll_interval_s=1.0,
                               debounce_s=30.0, clock=clock, **kw)


def test_watcher_flap_guard_and_debounce_expiry(ref, tmp_path) -> None:
    def scenario(mod, workdir):
        clock, incidents = _Clock(), [_incident(1)]
        w = _mk(mod, workdir, incidents, clock)
        first = w.poll_once(force=True)
        incidents.append(_incident(2))
        clock.t += 5.0
        inside = w.poll_once(force=True)
        incidents.append(_incident(3))
        clock.t += 31.0
        return [first, inside, w.poll_once(force=True)]

    (first, inside, again), journal = _both(ref, tmp_path, scenario)
    assert len(first) == 1 and (first[0]["policy"], first[0]["target"]) == ("drain", "g2")
    assert inside == []
    assert len(again) == 1 and again[0]["incident_id"] == 3
    assert [e["incident_id"] for e in journal] == [1, 3]


def test_watcher_poll_throttle_and_seen_dedup(ref, tmp_path) -> None:
    def scenario(mod, workdir):
        clock = _Clock()
        w = _mk(mod, workdir, [_incident(1)], clock)
        got = [len(w.poll_once(force=True)), w.poll_once()]
        clock.t += 50.0
        return got + [w.poll_once()]

    (counts, journal) = _both(ref, tmp_path, scenario)
    assert counts == [1, [], []] and len(journal) == 1


@pytest.mark.parametrize("act", [True, False])
def test_watcher_dry_run_vs_act(ref, tmp_path, act) -> None:
    def scenario(mod, workdir):
        drained = []
        w = _mk(mod, workdir, [_incident(1)], _Clock(), act=act, drain_cb=drained.append)
        return [w.poll_once(force=True)[0]["acted"], drained]

    (acted, drained), journal = _both(ref, tmp_path, scenario)
    assert acted is act and drained == (["g2"] if act else [])
    assert journal[0]["acted"] is act


def test_watcher_act_never_drains_the_cluster(ref, tmp_path) -> None:
    def scenario(mod, workdir):
        drained = []
        w = _mk(mod, workdir, [_incident(1, reason="alert:ec_coverage", replica="cluster")],
                _Clock(), act=True, drain_cb=drained.append)
        return [w.poll_once(force=True), drained]

    (entries, drained), _ = _both(ref, tmp_path, scenario)
    assert len(entries) == 1 and entries[0]["policy"] == "re-stripe"
    assert entries[0]["acted"] is False and drained == []


def test_watcher_a_failed_drain_is_journaled_unacted(ref, tmp_path) -> None:
    def scenario(mod, workdir):
        def boom(group):
            raise RuntimeError("nothing to drain")

        w = _mk(mod, workdir, [_incident(1)], _Clock(), act=True, drain_cb=boom)
        return w.poll_once(force=True)

    entries, _ = _both(ref, tmp_path, scenario)
    assert entries[0]["acted"] is False


def test_watcher_address_failover(ref, tmp_path) -> None:
    def scenario(mod, workdir):
        calls = []

        def fetch(address, path):
            calls.append(address)
            if address.endswith(":1"):
                return None  # a dead leader
            return {"incidents": []} if path == "/incident.json" else {}

        w = mod.IncidentWatcher(["http://127.0.0.1:1", "http://127.0.0.1:2"], str(workdir),
                                poll_interval_s=0.0, debounce_s=30.0, fetch=fetch)
        w.poll_once(force=True)
        serving = w.serving_address()
        calls.clear()
        w.poll_once(force=True)
        return [serving, calls[0]]

    (serving, first_call), _ = _both(ref, tmp_path, scenario)
    assert serving == first_call == "http://127.0.0.1:2"


def test_watcher_requires_an_address(tmp_path, monkeypatch) -> None:
    with pytest.raises(ValueError):
        port_watcher.IncidentWatcher([], str(tmp_path))
    with pytest.raises(ValueError):
        port_watcher.IncidentWatcher(["", ""], str(tmp_path))
    monkeypatch.setenv("TPUFT_WATCHER_POLL_S", "0.5")
    monkeypatch.setenv("TPUFT_WATCHER_DEBOUNCE_S", "-3")  # not positive: the default
    w = port_watcher.IncidentWatcher(["x:1"], str(tmp_path))
    assert (w.poll_interval_s, w.debounce_s) == (0.5, 30.0)
    assert w.journal_path == os.path.join(str(tmp_path), "watcher_journal.jsonl")


# -- one live lighthouse, two watchers -------------------------------------------------------


def _live_triggers(ref, monkeypatch):
    """A port-built lighthouse whose straggler alert and an eviction each
    record an incident trigger; returns (server, http address)."""
    _, _, jnative = ref
    monkeypatch.setenv("TPUFT_STRAGGLER_RATIO", "1.5")
    monkeypatch.setenv("TPUFT_STRAGGLER_WARMUP_STEPS", "0")
    monkeypatch.setenv("TPUFT_STRAGGLER_GRACE_STEPS", "2")
    monkeypatch.setenv("TPUFT_STRAGGLER_AUTO_DRAIN", "0")
    server = _native.LighthouseServer(bind="127.0.0.1:0", http_bind="127.0.0.1:0",
                                      min_replicas=1, join_timeout_ms=200)
    client = jnative.LighthouseClient(server.address())
    for rid in ("0:a", "1:b", "2:c"):
        client.heartbeat(rid, step=1, state="step", step_time_ms_ewma=200.0)
    for step in (2, 3, 4):
        client.heartbeat("1:b", step=step, state="step", step_time_ms_ewma=800.0)
    assert server.evict("2") == 1
    http = f"http://127.0.0.1:{server.http_address().rsplit(':', 1)[1]}"
    reasons = sorted(t["reason"] for t in port_incident.fetch_json(http, "/incident.json")
                     ["incidents"])
    assert reasons == ["alert:straggler", "replica_evicted"], reasons
    return server, http


def test_jax_and_port_watchers_journal_the_same_decisions(ref, tmp_path, monkeypatch) -> None:
    _, jwatcher, _ = ref
    server, http = _live_triggers(ref, monkeypatch)
    try:
        journals = []
        for name, mod in (("jax", jwatcher), ("port", port_watcher)):
            w = mod.IncidentWatcher([http], str(tmp_path / name))
            w.poll_once(force=True)
            assert w.poll_once(force=True) == []
            with open(w.journal_path) as f:
                journals.append([{k: v for k, v in json.loads(x).items() if k != "ts"}
                                 for x in f])
    finally:
        server.shutdown()
    assert journals[0] == journals[1]
    by_kind = {e["kind"]: e for e in journals[1]}
    assert set(by_kind) == {"straggler", "kill"}
    assert (by_kind["straggler"]["policy"], by_kind["straggler"]["target"]) == ("drain", "1")
    assert by_kind["straggler"]["acted"] is False
    assert (by_kind["kill"]["policy"], by_kind["kill"]["target"]) == ("respawn", "2")


def test_incident_cli_capture_and_verdict_equal_the_jax_tool(ref, tmp_path, monkeypatch) -> None:
    server, http = _live_triggers(ref, monkeypatch)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    try:
        outs = []
        for name, cmd in (("port", [sys.executable, "-m", "torchft_tpu_torch.tools.incident"]),
                          ("jax", [sys.executable, os.path.join(REPO, "tools", "incident.py")])):
            workdir = str(tmp_path / name)
            os.makedirs(workdir)
            r = subprocess.run(cmd + ["capture", workdir, "--lighthouse", http, "--json"],
                               capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
            assert r.returncode == 0, r.stderr
            captured = json.loads(r.stdout)
            verdicts = []
            for m in captured:
                r = subprocess.run(cmd + ["verdict", m["bundle"], "--json"], capture_output=True,
                                   text=True, timeout=120, cwd=REPO, env=env)
                assert r.returncode == 0, r.stderr
                verdicts.append(json.loads(r.stdout))
                assert verdicts[-1] == m["manifest"]["verdict"]
            r = subprocess.run(cmd + ["capture", workdir, "--lighthouse", http],
                               capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
            assert r.returncode == 0 and "kind=straggler replica=1" in r.stdout, r.stderr
            outs.append({v["incident"]["id"]: v for v in verdicts})
    finally:
        server.shutdown()
    # The heartbeats stopped, so later triggers (stale replicas) may reach
    # the second tool only: compare the triggers both saw.
    both = sorted(set(outs[0]) & set(outs[1]))
    assert [outs[0][i] for i in both] == [outs[1][i] for i in both]
    kinds = sorted(outs[0][i]["kind"] for i in both)
    assert "straggler" in kinds and "kill" in kinds
    r = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.tools.incident", "capture",
                        str(tmp_path), "--lighthouse", "http://127.0.0.1:1"],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 1 and "no incident triggers" in r.stderr


def test_watcher_main_journals_a_live_lighthouse(ref, tmp_path, monkeypatch) -> None:
    """``python -m torchft_tpu_torch.obs.watcher``'s ``main`` builds the
    watcher from its flags (addresses, workdir, metrics, --act) and runs
    it; one pass of its loop journals the live triggers."""
    server, http = _live_triggers(ref, monkeypatch)
    built = []

    def one_pass(self, stop=None) -> None:
        built.append(self)
        self.poll_once(force=True)

    monkeypatch.setattr(port_watcher.IncidentWatcher, "run", one_pass)
    try:
        metrics = tmp_path / "m.jsonl"
        metrics.write_text("")
        assert port_watcher.main(["--lighthouse", f"http://127.0.0.1:1, {http}",
                                  "--workdir", str(tmp_path), "--metrics", str(metrics)]) == 0
    finally:
        server.shutdown()
    (w,) = built
    assert w.addresses == ["http://127.0.0.1:1", http] and w.act is False
    assert w.metrics_paths == [str(metrics)] and w.serving_address() == http
    with open(w.journal_path) as f:
        kinds = sorted(json.loads(line)["kind"] for line in f)
    assert kinds == ["kill", "straggler"]
    r = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.obs.watcher", "--help"],
                       capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0 and "--lighthouse" in r.stdout and "--act" in r.stdout
