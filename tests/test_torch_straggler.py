"""The port launcher's straggler sentinel against the JAX launcher's.

- ``fetch_alerts`` against a real (port-built) ``LighthouseServer``: the
  JAX function's dict, and None without an address or a server.
- ``Launcher._sentinel_once`` over heartbeats fed to the port launcher's
  embedded lighthouse as tests/test_straggler.py feeds them: a straggler
  detected and rotated out once, then recovered; a suspect cleared by one
  good step (no drain); the warmup gate (no drain until past it); the
  lighthouse's own auto-drain racing the launcher's (the donor already
  gone: ``RuntimeError`` from ``drain`` falls back to ``spawn``); the
  ``min_replicas`` floor (the lighthouse does not mark, the launcher still
  rotates onto a replacement); a sole survivor's alert resolving.
- The stale-alert skip, the retry while the spare pool is empty, the poll
  throttle, a launcher without an embedded lighthouse.
- The same synthetic alert feed through the JAX and the port launcher
  gives the same drains, handled alerts and ``straggler_drain`` records.
- ``maybe_straggle``'s pid pin, against the JAX example's.

Every subprocess is a sleeping stand-in, killed at ``stop()``; every
socket wait has a timeout.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
import urllib.request

import pytest

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch import launch as port_launch
from torchft_tpu_torch.examples._common import maybe_straggle
from torchft_tpu_torch.launch import Launcher, fetch_alerts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLEEPER = [sys.executable, "-c", "import time; time.sleep(120)"]


@pytest.fixture(scope="module")
def ref():
    return import_reference("torchft_tpu._native"), import_reference("torchft_tpu.launch")


def _knobs(monkeypatch, grace: int = 3, warmup: int = 0, auto: str = "0") -> None:
    monkeypatch.setenv("TPUFT_STRAGGLER_RATIO", "1.5")
    monkeypatch.setenv("TPUFT_STRAGGLER_WARMUP_STEPS", str(warmup))
    monkeypatch.setenv("TPUFT_STRAGGLER_GRACE_STEPS", str(grace))
    monkeypatch.setenv("TPUFT_STRAGGLER_AUTO_DRAIN", auto)


def _get_json(http_address: str, path: str) -> dict:
    port = http_address.rsplit(":", 1)[1]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
        return json.loads(resp.read().decode())


class _Cluster:
    """A port Launcher of sleeping stand-ins with an embedded lighthouse and
    the straggler sentinel on, a JAX wire client feeding heartbeats under
    the ids ``"<group>:<tag>"``, and a record of the launcher's drains
    (which still run)."""

    def __init__(self, ref, tmp_path, groups: int = 2, spares: int = 0,
                 min_replicas: int = 1) -> None:
        jnative, _ = ref
        self.metrics_path = str(tmp_path / "launcher.jsonl")
        self.launcher = Launcher(SLEEPER, groups, lighthouse="embed", min_replicas=min_replicas,
                                 join_timeout_ms=200, log_dir=str(tmp_path), spares=spares,
                                 env={"TPUFT_METRICS_PATH": self.metrics_path},
                                 straggler_auto_drain=True)
        self.launcher.start()
        self.client = jnative.LighthouseClient(self.launcher.lighthouse_address)
        self.drains: list = []
        real = self.launcher.drain

        def drain(group: int, deadline_s: float = 30.0) -> None:
            self.drains.append(group)
            real(group, deadline_s)

        self.launcher.drain = drain

    def hb(self, rid: str, step: int, ewma: float) -> None:
        self.client.heartbeat(rid, step=step, state="step", step_time_ms_ewma=ewma,
                              step_time_ms_last=ewma)

    def sentinel(self) -> None:
        self.launcher._sentinel_last_poll = 0.0  # past the once-a-second throttle
        self.launcher._sentinel_once()

    def alerts(self) -> dict:
        return fetch_alerts(self.launcher.lighthouse_http_address)

    def events(self, name: str) -> list:
        with open(self.metrics_path) as f:
            return [e for e in map(json.loads, f) if e["event"] == name]

    def close(self) -> None:
        self.launcher.stop()


@pytest.fixture
def cluster(ref, tmp_path):
    made = []

    def make(**kw) -> _Cluster:
        c = _Cluster(ref, tmp_path, **kw)
        made.append(c)
        return c

    yield make
    for c in made:
        c.close()


# -- fetch_alerts ------------------------------------------------------------------


def test_fetch_alerts_equals_the_jax_function(ref, monkeypatch) -> None:
    jnative, jlaunch = ref
    _knobs(monkeypatch)
    server = _native.LighthouseServer(bind="127.0.0.1:0", http_bind="127.0.0.1:0",
                                      min_replicas=1, join_timeout_ms=200)
    try:
        client = jnative.LighthouseClient(server.address())
        http = server.http_address()
        assert fetch_alerts(http) == jlaunch.fetch_alerts(http) == {"alerts": [], "active": 0}
        for step, ewma in ((1, 200.0), (2, 600.0), (3, 600.0), (4, 600.0)):
            client.heartbeat("0:a", step=step, state="step", step_time_ms_ewma=200.0)
            client.heartbeat("1:b", step=step, state="step", step_time_ms_ewma=ewma)
        got = fetch_alerts(http)
        assert got == jlaunch.fetch_alerts(http) == _get_json(http, "/alerts.json")
        (alert,) = got["alerts"]
        assert alert["kind"] == "straggler" and alert["replica_id"] == "1:b" and alert["active"]
    finally:
        server.shutdown()
    assert fetch_alerts("") is None and fetch_alerts(http, timeout=1.0) is None


# -- the sentinel over the lighthouse's state machine -------------------------------


def test_sentinel_detects_rotates_once_and_recovers(cluster, monkeypatch) -> None:
    _knobs(monkeypatch)
    c = cluster()
    c.hb("0:fast", 1, 200.0)
    c.hb("1:slow", 1, 200.0)
    c.sentinel()
    c.hb("1:slow", 2, 600.0)  # suspect: never acted on
    c.sentinel()
    assert c.drains == []
    c.hb("0:fast", 2, 200.0)
    c.hb("1:slow", 3, 600.0)
    c.hb("1:slow", 4, 600.0)
    assert c.alerts()["active"] == 1
    donor = c.launcher.pid(1)
    c.sentinel()
    assert c.drains == [1]
    assert c.launcher.pid(1) != donor and c.launcher.draining() == [1]
    (ev,) = c.events("straggler_drain")
    (alert,) = c.alerts()["alerts"]
    assert (ev["group"], ev["replica_id"], ev["alert_id"]) == ("1", "1:slow", alert["id"])
    assert ev["ratio"] == pytest.approx(3.0) and ev["step_time_ms"] == alert["step_time_ms"]
    c.sentinel()  # a handled alert is never acted on twice
    assert c.drains == [1]
    for step in (5, 6, 7):  # recovery needs the full grace of on-pace steps
        c.hb("1:slow", step, 200.0)
    assert c.alerts()["active"] == 0
    c.sentinel()
    assert c.drains == [1]


def test_sentinel_ignores_a_suspect_cleared_by_one_good_step(cluster, monkeypatch) -> None:
    _knobs(monkeypatch)
    c = cluster()
    c.hb("0:a", 1, 200.0)
    c.hb("1:b", 1, 200.0)
    c.hb("1:b", 2, 600.0)
    c.sentinel()
    c.hb("1:b", 3, 210.0)
    c.sentinel()
    assert c.drains == [] and c.alerts()["active"] == 0 and c.events("straggler_drain") == []


def test_sentinel_waits_out_the_warmup_gate(cluster, monkeypatch) -> None:
    _knobs(monkeypatch, grace=2, warmup=5)
    c = cluster()
    for step in range(1, 6):
        c.hb("0:a", step, 100.0)
        c.hb("1:b", step, 900.0)  # slow from birth: held at suspect
        c.sentinel()
    assert c.drains == [] and c.alerts()["active"] == 0
    c.hb("1:b", 6, 900.0)  # the first observation past the warmup promotes
    c.sentinel()
    assert c.drains == [1]


def test_lighthouse_auto_drain_races_the_launchers(cluster, monkeypatch, ref) -> None:
    """With ``TPUFT_STRAGGLER_AUTO_DRAIN=1`` the lighthouse marks the
    straggler draining itself and a cooperative donor exits on its "is
    draining" refusal: the launcher's ``drain`` then raises, and the
    sentinel refills the slot with ``spawn``."""
    _knobs(monkeypatch, grace=2, auto="1")
    c = cluster(spares=1)
    c.hb("0:a", 1, 200.0)
    c.hb("1:b", 1, 200.0)
    c.hb("1:b", 2, 800.0)
    c.hb("1:b", 3, 800.0)
    assert "1:b" in list(c.client.status().draining)
    (alert,) = c.alerts()["alerts"]
    assert alert["auto_drained"] is True
    with pytest.raises(RuntimeError, match="is draining"):
        c.client.quorum("1:b", timeout_ms=2000, step=3)
    # The donor has left (exit 0, not yet reaped by a supervise pass).
    g = c.launcher._groups[1]
    donor = g.proc
    donor.kill()
    donor.wait(timeout=10)
    spare_pid = c.launcher._spares[0].proc.pid
    c.sentinel()
    assert c.drains == [1]
    assert c.launcher.pid(1) == spare_pid  # spawn() handed the slot to the spare
    assert c.launcher.draining() == [] and len(c.events("straggler_drain")) == 1


def test_the_min_replicas_floor_defers_the_lighthouse_not_the_launcher(cluster, monkeypatch):
    """At ``min_replicas`` 2 the lighthouse's own mark would leave one
    group and is skipped; the launcher's rotation puts a replacement in the
    slot, so it acts."""
    _knobs(monkeypatch, grace=2, auto="1")
    c = cluster(min_replicas=2)
    c.hb("0:a", 1, 200.0)
    c.hb("1:b", 1, 200.0)
    c.hb("1:b", 2, 800.0)
    c.hb("1:b", 3, 800.0)
    alerts = c.alerts()
    assert alerts["active"] == 1 and alerts["alerts"][0]["auto_drained"] is False
    assert list(c.client.status().draining) == []
    c.sentinel()
    assert c.drains == [1] and c.launcher.draining() == [1]


def test_a_sole_survivors_alert_resolves_and_is_never_acted_on(cluster, monkeypatch) -> None:
    _knobs(monkeypatch, grace=2)
    c = cluster()
    c.launcher._straggler_auto_drain = False  # observe the alert first
    c.hb("0:a", 1, 200.0)
    c.hb("1:b", 1, 200.0)
    c.hb("1:b", 2, 800.0)
    c.hb("1:b", 3, 800.0)
    assert c.alerts()["active"] == 1
    assert c.launcher._embedded.evict("0") == 1  # its only peer dies
    c.hb("1:b", 4, 800.0)
    c.hb("1:b", 5, 800.0)
    assert c.alerts()["active"] == 0
    c.launcher._straggler_auto_drain = True
    c.sentinel()
    assert c.drains == []


# -- the sentinel's own rules --------------------------------------------------------


def _straggle(c: _Cluster, rid: str = "1:b") -> None:
    c.hb("0:a", 1, 200.0)
    c.hb(rid, 1, 200.0)
    for step in (2, 3, 4):
        c.hb(rid, step, 800.0)
    assert c.alerts()["active"] == 1


def test_a_stale_alert_never_drains_the_younger_replacement(cluster, monkeypatch) -> None:
    _knobs(monkeypatch, grace=2)
    c = cluster()
    _straggle(c)
    time.sleep(1.3)  # the alert is older than the replacement below by > 1 s
    # The alerted incarnation dies and is replaced before the lighthouse
    # resolves its alert (no evict: the alert stays active).
    old = c.launcher._groups[1].proc
    old.kill()
    old.wait(timeout=10)
    c.launcher.spawn(1)
    assert c.alerts()["active"] == 1
    c.sentinel()
    (alert,) = c.alerts()["alerts"]
    assert c.drains == [] and alert["id"] in c.launcher._handled_alerts


def test_the_sentinel_retries_while_the_spare_pool_refills(cluster, monkeypatch) -> None:
    _knobs(monkeypatch, grace=2)
    c = cluster(spares=1)
    _straggle(c)
    monkeypatch.setattr(c.launcher, "spare_count", lambda: 0)
    c.sentinel()
    assert c.drains == [] and not c.launcher._handled_alerts
    monkeypatch.undo()
    c.sentinel()
    assert c.drains == [1]


def test_drain_error_falls_back_to_spawn(cluster, monkeypatch) -> None:
    _knobs(monkeypatch, grace=2)
    c = cluster()
    _straggle(c)
    donor = c.launcher._groups[1].proc
    donor.kill()
    donor.wait(timeout=10)
    c.sentinel()
    assert c.drains == [1]
    new = c.launcher.pid(1)
    assert new is not None and new != donor.pid


def test_throttle_and_no_embedded_lighthouse(cluster, monkeypatch, tmp_path) -> None:
    _knobs(monkeypatch, grace=2)
    c = cluster()
    _straggle(c)
    c.launcher._sentinel_last_poll = time.monotonic()  # polled just now
    c.launcher._sentinel_once()
    assert c.drains == []
    calls = []
    monkeypatch.setattr(port_launch, "fetch_alerts", lambda *a, **k: calls.append(a))
    external = Launcher(SLEEPER, 1, lighthouse="127.0.0.1:1", log_dir=str(tmp_path / "ext"),
                        straggler_auto_drain=True)
    try:
        external._sentinel_once()
        assert calls == [] and external.lighthouse_http_address == ""
    finally:
        external.stop()
    monkeypatch.setenv("TPUFT_STRAGGLER_AUTO_DRAIN", "1")
    env_on = Launcher(SLEEPER, 1, log_dir=str(tmp_path / "env"))
    try:
        assert env_on._straggler_auto_drain is True
    finally:
        env_on.stop()


# -- the same feed through both launchers -------------------------------------------


def test_one_feed_gives_the_jax_launchers_decisions(ref, monkeypatch, tmp_path) -> None:
    _, jlaunch = ref
    now_ms = time.time() * 1e3
    feed = {"alerts": [
        {"id": 1, "kind": "straggler", "active": True, "replica_id": "0:a",
         "raised_ms": now_ms - 100, "ratio": 2.5, "step_time_ms": 900},
        {"id": 2, "kind": "straggler", "active": False, "replica_id": "1:b", "raised_ms": now_ms},
        {"id": 3, "kind": "slow_link", "active": True, "replica_id": "1:b", "raised_ms": now_ms},
        {"id": 4, "kind": "straggler", "active": True, "replica_id": "7:x", "raised_ms": now_ms},
        {"id": 5, "kind": "straggler", "active": True, "replica_id": "bad", "raised_ms": now_ms},
        # Raised a minute before group 2's process started: stale.
        {"id": 6, "kind": "straggler", "active": True, "replica_id": "2:c",
         "raised_ms": now_ms - 60e3, "ratio": 3.0, "step_time_ms": 800},
        {"id": 7, "kind": "straggler", "active": True, "replica_id": "1:b",
         "raised_ms": now_ms - 50, "ratio": 1.75, "step_time_ms": 700},
    ]}
    results = []
    procs = [subprocess.Popen(SLEEPER) for _ in range(3)]
    try:
        for mod in (jlaunch, port_launch):
            monkeypatch.setattr(mod, "fetch_alerts", lambda *a, **k: json.loads(json.dumps(feed)))
            path = str(tmp_path / f"{mod.__name__}.jsonl")
            la = mod.Launcher(SLEEPER, 3, lighthouse=None, log_dir=str(tmp_path / mod.__name__),
                              env={"TPUFT_METRICS_PATH": path}, straggler_auto_drain=True)
            la.lighthouse_http_address = "127.0.0.1:9"
            for g, p in enumerate(procs):
                la._groups[g].proc = p
                la._groups[g].spawned_at = time.monotonic() - (1.0 if g == 2 else 600.0)
            drained = []
            la.drain = lambda group, deadline_s=30.0, out=drained: out.append((group, deadline_s))
            la._sentinel_once()
            la._sentinel_once()  # throttled: no second poll
            la._metrics.close()
            with open(path) as f:
                events = [{k: v for k, v in e.items() if k not in ("ts", "t_mono", "replica_id")}
                          | {"rid": e.get("replica_id")} for e in map(json.loads, f)]
            results.append((drained, sorted(la._handled_alerts), events))
            for g in la._groups.values():
                g.proc = None
            la.stop()
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)
    assert results[0] == results[1]
    assert results[1][0] == [(0, 30.0), (1, 30.0)] and results[1][1] == [1, 6, 7]


# -- maybe_straggle ----------------------------------------------------------------------


def test_maybe_straggle_is_pinned_to_a_pid(tmp_path, monkeypatch) -> None:
    spec = importlib.util.spec_from_file_location("_jax_examples_common",
                                                  os.path.join(REPO, "examples", "_common.py"))
    jcommon = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcommon)
    path = tmp_path / "straggle_3.json"

    def both(group: int = 3) -> tuple:
        return maybe_straggle(group), jcommon.maybe_straggle(group)

    monkeypatch.delenv("TPUFT_STRAGGLE_DIR", raising=False)
    path.write_text(json.dumps({"sleep_s": 0.05, "pid": os.getpid()}))
    assert both() == (0.0, 0.0)  # no directory: off
    monkeypatch.setenv("TPUFT_STRAGGLE_DIR", str(tmp_path))
    t0 = time.monotonic()
    assert both() == (0.05, 0.05)
    assert time.monotonic() - t0 >= 0.1
    assert both(4) == (0.0, 0.0)  # another group
    for data in ({"sleep_s": 0.05, "pid": os.getpid() + 1},  # another incarnation
                 {"sleep_s": 0.05},  # pid-less: refused
                 {"sleep_s": 0.0, "pid": os.getpid()}):
        path.write_text(json.dumps(data))
        assert both() == (0.0, 0.0)
    path.write_text("{not json")
    assert both() == (0.0, 0.0)
