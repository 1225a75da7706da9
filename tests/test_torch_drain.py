"""The port's cooperative drain against the JAX package's
(tests/test_drain.py's cases).

- The watcher, on both packages side by side: the notice file fires once,
  carries its deadline and is consumed; a notice pinned to another pid is
  left alone; a pid-less file under a supervising launcher is left to it;
  SIGTERM becomes a notice and the earlier handler still runs; the GCE
  poll (a loopback stub) turns ``preempted=TRUE`` into a 30 s notice; the
  first notice wins; the deadline math.
- The lighthouse: a drain (in-process and over the wire) leaves the
  incarnation out of the next quorum at once and refuses its joins as
  ``"is draining"``; a port Manager refused so
  begins its own drain, as the JAX Manager does, and heartbeats
  ``"draining"``.
- The launcher: ``drain()`` hands the id to a replacement at once and reaps
  the donor, an operator's pid-less file is re-issued, a donor that ignores
  its notice is escalated; on the JAX launcher too.
- The handoff: two train_ddp groups on the CPU under the port's launcher
  with a hot spare; the drained group's id goes to the spare, the survivor
  fails no commit and never stops committing, and the stream holds the
  notice -> handoff -> complete chain with a clean donor exit.
"""

from __future__ import annotations

import http.server
import json
import os
import signal
import sys
import threading
import time
from datetime import timedelta

import pytest

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.collectives import TCPCollective
from torchft_tpu_torch.drain import DrainNotice, DrainWatcher
from torchft_tpu_torch.drain import watcher as port_watcher
from torchft_tpu_torch.launch import Launcher
from torchft_tpu_torch.manager import Manager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST = "127.0.0.1"


@pytest.fixture(scope="module")
def jax_drain():
    return import_reference("torchft_tpu.drain")


def _watcher_cls(which: str, jax_drain):
    return DrainWatcher if which == "port" else jax_drain.DrainWatcher


def _wait(predicate, timeout: float, launcher=None) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if launcher is not None:
            launcher.supervise_once()
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError("condition not reached in time")


def test_knobs_and_defaults_equal_the_jax_package(jax_drain) -> None:
    for name in ("DRAIN_DIR_ENV", "DRAIN_GRACE_ENV", "GCE_METADATA_URL_ENV", "GCE_POLL_ENV"):
        assert getattr(port_watcher, name) == getattr(jax_drain, name)
    ref = import_reference("torchft_tpu.drain.watcher")
    assert port_watcher._DEFAULT_GRACE_S == ref._DEFAULT_GRACE_S == 30.0
    assert port_watcher._GCE_DEFAULT_URL == ref._GCE_DEFAULT_URL


@pytest.mark.parametrize("which", ["port", "jax"])
def test_watcher_file_notice_roundtrip(tmp_path, jax_drain, which) -> None:
    fired = []
    w = _watcher_cls(which, jax_drain)(on_notice=fired.append, group_id="3", sigterm=False,
                                       drain_dir=str(tmp_path), poll_interval_s=0.02).start()
    try:
        path = tmp_path / "drain_3.json"
        path.write_text(json.dumps({"deadline_ms": 12000, "source": "supervisor",
                                    "pid": os.getpid()}))
        _wait(lambda: fired, timeout=5)  # the callback runs after wait() wakes
        notice = fired[0]
        assert notice.source == "supervisor" and 8.0 < notice.remaining_s() <= 12.0
        assert w.drain_requested() and not path.exists()
        w.trigger("second")  # the first notice wins
        assert w.notice is notice and len(fired) == 1
    finally:
        w.stop()


@pytest.mark.parametrize("which", ["port", "jax"])
def test_watcher_file_notice_pid_pinning(tmp_path, jax_drain, which) -> None:
    fired = []
    w = _watcher_cls(which, jax_drain)(on_notice=fired.append, group_id="1", sigterm=False,
                                       drain_dir=str(tmp_path), poll_interval_s=0.02).start()
    try:
        path = tmp_path / "drain_1.json"
        path.write_text(json.dumps({"deadline_ms": 5000, "source": "supervisor",
                                    "pid": os.getpid() + 999983}))
        assert w.wait(0.3) is None and not fired
        assert path.exists(), "a notice for another pid is left for its addressee"
    finally:
        w.stop()


@pytest.mark.parametrize("which", ["port", "jax"])
def test_watcher_leaves_an_operator_file_to_its_supervisor(tmp_path, jax_drain, monkeypatch,
                                                           which) -> None:
    monkeypatch.setenv("TPUFT_DRAIN_SUPERVISED", "1")
    fired = []
    w = _watcher_cls(which, jax_drain)(on_notice=fired.append, group_id="2", sigterm=False,
                                       drain_dir=str(tmp_path), poll_interval_s=0.02).start()
    try:
        (tmp_path / "drain_2.json").write_text("{}")
        assert w.wait(0.3) is None and (tmp_path / "drain_2.json").exists()
    finally:
        w.stop()


@pytest.mark.parametrize("which", ["port", "jax"])
def test_watcher_sigterm_hook(jax_drain, which) -> None:
    chained = []
    original = signal.getsignal(signal.SIGTERM)
    prev = lambda signum, frame: chained.append(signum)  # noqa: E731
    signal.signal(signal.SIGTERM, prev)
    fired = []
    w = _watcher_cls(which, jax_drain)(on_notice=fired.append, group_id="0",
                                       grace_s=7.0).start()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        _wait(lambda: fired, timeout=5)  # the callback runs after wait() wakes
        assert fired[0].source == "sigterm" and 5.0 < fired[0].remaining_s() <= 7.0
        assert chained == [signal.SIGTERM]
    finally:
        w.stop()
        assert signal.getsignal(signal.SIGTERM) is prev
        signal.signal(signal.SIGTERM, original)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_watcher_gce_metadata_stub(jax_drain, which) -> None:
    class Stub(http.server.BaseHTTPRequestHandler):
        preempted = b"FALSE"

        def do_GET(self):  # noqa: N802
            assert self.headers.get("Metadata-Flavor") == "Google"
            body = Stub.preempted if self.path.endswith("/preempted") else b"NONE"
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = http.server.HTTPServer((HOST, 0), Stub)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    fired = []
    w = _watcher_cls(which, jax_drain)(on_notice=fired.append, group_id="0", sigterm=False,
                                       gce_url=f"http://{HOST}:{server.server_port}",
                                       poll_interval_s=0.05).start()
    try:
        assert w.wait(0.3) is None, "no notice while preempted=FALSE"
        Stub.preempted = b"TRUE"
        _wait(lambda: fired, timeout=5)  # the callback runs after wait() wakes
        assert fired[0].source == "gce-preemption" and 25.0 < fired[0].remaining_s() <= 30.0
    finally:
        w.stop()
        server.shutdown()


def test_gce_poll_is_off_unless_asked(monkeypatch) -> None:
    for name in ("TPUFT_GCE_METADATA_URL", "TPUFT_GCE_DRAIN_POLL"):
        monkeypatch.delenv(name, raising=False)
    assert not DrainWatcher(sigterm=False)._gce_enabled
    monkeypatch.setenv("TPUFT_GCE_DRAIN_POLL", "1")
    assert DrainWatcher(sigterm=False)._gce_enabled


def test_notice_deadline_math(jax_drain) -> None:
    t = time.time() + 2.0
    for notice in (DrainNotice(source="manual", deadline=t),
                   jax_drain.DrainNotice(source="manual", deadline=t)):
        assert 1.0 < notice.remaining_s() <= 2.0
        assert 1000 < notice.deadline_ms_from_now() <= 2000
    assert DrainNotice(source="x", deadline=0.0).deadline_ms_from_now() == 0


# -- the lighthouse ------------------------------------------------------------------


@pytest.mark.parametrize("how", ["in_process", "wire"])
def test_lighthouse_drain_excludes_next_quorum(how) -> None:
    jax_native = import_reference("torchft_tpu._native")
    server = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1, join_timeout_ms=200,
                                      quorum_tick_ms=20, heartbeat_timeout_ms=5000)
    client = jax_native.LighthouseClient(server.address())
    port_client = _native.LighthouseClient(server.address())
    try:
        q1 = client.quorum("1:aaaa", timeout_ms=10000, step=4)
        assert [m.replica_id for m in q1.participants] == ["1:aaaa"]
        if how == "in_process":
            assert server.drain("1:aaaa", 30000) == 1
            assert server.drain("1:aaaa") == 0  # idempotent
        else:
            assert port_client.drain("1:aaaa", deadline_ms=30000, trace_id="t#1") == 1
            assert port_client.drain("1:aaaa") == 0
        t0 = time.monotonic()
        q2 = client.quorum("0:bbbb", timeout_ms=10000, step=5)
        assert [m.replica_id for m in q2.participants] == ["0:bbbb"]
        assert time.monotonic() - t0 < 2.0, "the drain must beat the heartbeat wait"
        with pytest.raises(RuntimeError, match="is draining"):
            client.quorum("1:aaaa", timeout_ms=3000, step=5)
        assert list(client.status().draining) == ["1:aaaa"]
    finally:
        port_client.close()
        client.close()
        server.shutdown()


def test_manager_refused_as_draining_begins_its_drain_like_the_jax_one() -> None:
    """Both packages' Managers, marked draining at the lighthouse between
    steps, take the next quorum's refusal as a drain notice with the
    refusal's deadline, fail that step's vote, and heartbeat "draining"."""
    ref = {n: import_reference(f"torchft_tpu.{n}") for n in ("manager", "collectives",
                                                              "_native")}
    lh = _native.LighthouseServer(bind=f"{HOST}:0", min_replicas=1, join_timeout_ms=100)
    client = ref["_native"].LighthouseClient(lh.address())
    timeout = timedelta(seconds=10)
    managers = {
        "port": Manager(collective=TCPCollective(timeout=10.0, host=HOST),
                        load_state_dict=None, state_dict=None, min_replica_size=1,
                        timeout=timeout, quorum_timeout=timeout, rank=0, world_size=1,
                        replica_id="dport", lighthouse_addr=lh.address(), store_addr=HOST,
                        manager_bind=f"{HOST}:0"),
        "jax": ref["manager"].Manager(collective=ref["collectives"].TCPCollective(timeout=10.0),
                                      load_state_dict=None, state_dict=None,
                                      min_replica_size=1, timeout=timeout,
                                      quorum_timeout=timeout, rank=0, world_size=1,
                                      replica_id="djax", lighthouse_addr=lh.address()),
    }
    seen = {}
    try:
        for kind, m in managers.items():
            m.start_quorum()
            assert m.should_commit()
            lh.drain(m.replica_id(), 20000)
            m.start_quorum()
            committed = m.should_commit()
            notice = m.drain_notice()
            seen[kind] = (committed, m.drain_requested(), notice.source,
                          15.0 < notice.remaining_s() <= 20.0)
        _wait(lambda: {client.status().replica_state.get(m.replica_id())
                       for m in managers.values()} == {"draining"}, timeout=10)
    finally:
        for m in managers.values():
            m.shutdown()
        client.close()
        lh.shutdown()
    assert seen["port"] == seen["jax"] == (False, True, "lighthouse", True)


# -- the launcher ------------------------------------------------------------------------

# A drain-aware child with no Manager: the watcher alone.
_DRAIN_CHILD = (
    "import os, sys; sys.path.insert(0, os.environ['TPUFT_TEST_REPO']);"
    "from {pkg}.drain import DrainWatcher;"
    "w = DrainWatcher(sigterm=False, poll_interval_s=0.02).start();"
    "print('up', os.environ['REPLICA_GROUP_ID'], flush=True);"
    "n = w.wait(60);"
    "print('drained', n.source, flush=True)"
)


def _launcher(which: str, cmd, tmp_path, **kw):
    cls = Launcher if which == "port" else import_reference("torchft_tpu.launch").Launcher
    pkg = "torchft_tpu_torch" if which == "port" else "torchft_tpu"
    argv = [sys.executable, "-c", cmd.format(pkg=pkg)] if cmd else kw.pop("argv")
    # No lighthouse: the supervisor's own drain mark has nowhere to go.
    return cls(argv, num_groups=1, lighthouse=None, log_dir=str(tmp_path),
               env={"TPUFT_TEST_REPO": REPO, "TPUFT_LIGHTHOUSE": None}, **kw)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_launcher_drain_hands_off_and_reaps_donor(tmp_path, which) -> None:
    with _launcher(which, _DRAIN_CHILD, tmp_path) as launcher:
        _wait(lambda: b"up 0" in (tmp_path / "g0.log").read_bytes(), timeout=30)
        donor_pid = launcher._groups[0].proc.pid
        launcher.drain(0, deadline_s=20.0)
        assert launcher._groups[0].proc.pid != donor_pid, "the replacement starts at notice time"
        assert launcher.draining() == [0]
        _wait(lambda: not launcher.draining(), timeout=30, launcher=launcher)
        assert (tmp_path / "g0.log").read_text().count("drained supervisor") == 1
        _wait(lambda: (tmp_path / "g0.log").read_text().count("up 0") == 2, timeout=30)
        assert not (tmp_path / "drain_0.json").exists()


@pytest.mark.parametrize("which", ["port", "jax"])
def test_launcher_operator_drain_file(tmp_path, which) -> None:
    with _launcher(which, _DRAIN_CHILD, tmp_path) as launcher:
        _wait(lambda: b"up 0" in (tmp_path / "g0.log").read_bytes(), timeout=30)
        donor_pid = launcher._groups[0].proc.pid
        (tmp_path / "drain_0.json").write_text(json.dumps({"deadline_ms": 15000,
                                                           "source": "operator"}))
        _wait(lambda: launcher._groups[0].proc.pid != donor_pid, timeout=30, launcher=launcher)
        _wait(lambda: not launcher.draining(), timeout=30, launcher=launcher)
        assert (tmp_path / "g0.log").read_text().count("drained supervisor") == 1
        _wait(lambda: (tmp_path / "g0.log").read_text().count("up 0") == 2, timeout=30)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_launcher_drain_escalates_noncooperative_donor(tmp_path, which) -> None:
    """A donor that ignores SIGTERM too is SIGKILLed 5 s past its deadline
    (its replacement, which finds the marker file, does not ignore it)."""
    marker = tmp_path / "first"
    stubborn = ("import os, signal, time\n"
                f"if not os.path.exists({str(marker)!r}):\n"
                f"    open({str(marker)!r}, 'w').close()\n"
                "    signal.signal(signal.SIGTERM, signal.SIG_IGN)\n"
                "print('up', flush=True); time.sleep(120)")
    with _launcher(which, None, tmp_path, argv=[sys.executable, "-c", stubborn]) as launcher:
        _wait(lambda: b"up" in (tmp_path / "g0.log").read_bytes(), timeout=30)
        donor = launcher._groups[0].proc
        launcher.drain(0, deadline_s=0.3)
        _wait(lambda: not launcher.draining(), timeout=30, launcher=launcher)
        assert donor.returncode == -signal.SIGKILL


def test_drain_dir_is_the_log_dir_or_a_temporary_one(tmp_path) -> None:
    with Launcher([sys.executable, "-c", "import time; time.sleep(30)"], num_groups=1,
                  log_dir=str(tmp_path)) as launcher:
        assert launcher._base_env["TPUFT_DRAIN_DIR"] == str(tmp_path)
    launcher = Launcher([sys.executable, "-c", "pass"], num_groups=1)
    work = launcher._base_env["TPUFT_DRAIN_DIR"]
    assert os.path.isdir(work) and launcher._base_env["TPUFT_DRAIN_SUPERVISED"] == "1"
    launcher.start()
    launcher.stop()
    assert not os.path.exists(work)


# -- the handoff, end to end -----------------------------------------------------------


def _events(path: str) -> list:
    out = []
    try:
        with open(path, "rb") as f:
            for line in f:
                try:
                    out.append(json.loads(line))
                except ValueError:
                    pass
    except OSError:
        pass
    return out


def _commits(events, group: str, committed: bool = True):
    return [e for e in events if e.get("event") == "commit"
            and bool(e.get("committed")) == committed
            and str(e.get("replica_id", "")).split(":", 1)[0] == group]


def test_drain_handoff_to_a_hot_spare_with_no_failed_survivor_commit(tmp_path) -> None:
    metrics = str(tmp_path / "metrics.jsonl")
    with Launcher([sys.executable, "-m", "torchft_tpu_torch.examples.train_ddp", "--device",
                   "cpu", "--steps", "1000000", "--batch", "8"],
                  num_groups=2, lighthouse="embed", log_dir=str(tmp_path), cwd=REPO,
                  env={"TPUFT_METRICS_PATH": metrics, "OMP_NUM_THREADS": "1"},
                  spares=1) as launcher:
        def spare_ready() -> bool:
            return any(s.proc.poll() is None and (tmp_path / f"spare_{s.sid}.log").exists()
                       and b"[spare] ready" in (tmp_path / f"spare_{s.sid}.log").read_bytes()
                       for s in launcher._spares)

        _wait(lambda: all(len(_commits(_events(metrics), g)) >= 5 for g in ("0", "1"))
              and spare_ready(), timeout=120, launcher=launcher)
        spare = launcher._spares[0]
        pre = {e["replica_id"] for e in _events(metrics)
               if str(e.get("replica_id", "")).startswith("1:")}
        t_notice = time.time()
        launcher.drain(1, deadline_s=30.0)
        assert launcher._groups[1].proc.pid == spare.proc.pid
        _wait(lambda: [e for e in _commits(_events(metrics), "1") if e["replica_id"] not in pre]
              and not launcher.draining(), timeout=120, launcher=launcher)
        events = _events(metrics)
    assert not [e for e in _commits(events, "0", committed=False) if e["ts"] >= t_notice]
    names = [e["event"] for e in events]
    for name in ("drain_handoff", "drain_notice", "drain_complete", "drain_donor_exit"):
        assert name in names, name
    assert [e["hot_spare"] for e in events if e["event"] == "drain_handoff"] == [True]
    assert [e["exit_code"] for e in events if e["event"] == "drain_donor_exit"] == [0]
    new = min(e["ts"] for e in _commits(events, "1") if e["replica_id"] not in pre)
    # The survivor never stopped: it committed between the notice and the
    # replacement's first commit.
    assert [e for e in _commits(events, "0") if t_notice <= e["ts"] <= new]
    log = (tmp_path / f"spare_{spare.sid}.log").read_text()
    assert "adopted replica group 1" in log and "healing from replica" in log
    assert "DRAIN exit" in (tmp_path / "g1.log").read_text()
