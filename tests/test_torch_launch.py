"""The port's launcher and restart supervisor, on the CPU.

Twins of the JAX-free cases of tests/test_launch.py (tiny ``python -c``
children), an eviction at the lighthouse seen through its status page, the
wire evict, and the supervised kill-and-heal drive of the train_ddp example
with ``--device cpu``.  Hot spares (tests/test_launch.py:128's adoption,
the refill of a dead spare, the fast-death brake, a group with its own
environment spawning cold, ``--spares`` on the CLI) run on the port's
launcher and the JAX package's side by side with the same children.
"""

from __future__ import annotations

import json
import os
import sys
import time
import urllib.request

import pytest

from torch_port_ref import import_reference
from torchft_tpu_torch import _native
from torchft_tpu_torch.examples.kill_heal import _Tail, kill_and_heal, stop_and_resume
from torchft_tpu_torch.launch import Launcher, main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PRINT_ENV_AND_SLEEP = (
    "import os,time;"
    "print('gid', os.environ['REPLICA_GROUP_ID'], os.environ['NUM_REPLICA_GROUPS'],"
    " os.environ.get('TPUFT_LIGHTHOUSE',''), os.environ['MASTER_ADDR'], flush=True);"
    "time.sleep(60)"
)

# A replica group as the lighthouse sees one: a manager server that
# heartbeats as "<group>:x" until it is killed.
_HEARTBEATING_GROUP = (
    "import os,time;"
    "from torchft_tpu_torch import _native;"
    "m = _native.ManagerServer(replica_id=os.environ['REPLICA_GROUP_ID'] + ':x',"
    " lighthouse_addr=os.environ['TPUFT_LIGHTHOUSE'], bind='127.0.0.1:0',"
    " store_addr='127.0.0.1:1');"
    "print('up', flush=True); time.sleep(60)"
)


def _wait(predicate, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError("condition not reached in time")


def test_launcher_env_plumbing_and_restart(tmp_path) -> None:
    """Each group gets REPLICA_GROUP_ID / NUM_REPLICA_GROUPS /
    TPUFT_LIGHTHOUSE / MASTER_ADDR; a SIGKILLed group is respawned by
    supervise_once."""
    with Launcher([sys.executable, "-c", _PRINT_ENV_AND_SLEEP], num_groups=2,
                  lighthouse="embed", max_restarts=3, log_dir=str(tmp_path)) as launcher:
        assert launcher.lighthouse_address
        assert launcher.lighthouse_http_address.startswith("http://")
        _wait(lambda: all(
            (tmp_path / f"g{g}.log").exists() and b"gid" in (tmp_path / f"g{g}.log").read_bytes()
            for g in (0, 1)
        ))
        pid = launcher.pid(1)
        launcher.kill(1, hold=False)
        assert launcher.pid(1) is None
        assert launcher.supervise_once() == [1]
        assert launcher.restarts(1) == 1 and launcher.restarts(0) == 0
        assert launcher.pid(1) not in (None, pid)
        _wait(lambda: (tmp_path / "g1.log").read_bytes().count(b"gid") >= 2)

    log0 = (tmp_path / "g0.log").read_text()
    assert f"gid 0 2 {launcher.lighthouse_address} localhost" in log0


def test_launcher_creates_log_dir(tmp_path) -> None:
    log_dir = tmp_path / "nested" / "logs"
    with Launcher([sys.executable, "-c", "print('ok')"], num_groups=1, lighthouse="embed",
                  log_dir=str(log_dir)):
        _wait(lambda: (log_dir / "g0.log").exists())


def test_launcher_hold_and_budget(tmp_path) -> None:
    """kill() with hold keeps the supervisor's hands off until spawn(); an
    exhausted restart budget is reported, not retried."""
    with Launcher([sys.executable, "-c", "import time; time.sleep(60)"], num_groups=1,
                  lighthouse=None, max_restarts=0, log_dir=str(tmp_path),
                  env={"TPUFT_LIGHTHOUSE": None}) as launcher:
        launcher.kill(0)  # hold=True by default
        assert launcher.supervise_once() == []
        launcher.spawn(0)
        _wait(lambda: launcher.running())
        launcher.kill(0, hold=False)
        assert launcher.supervise_once() == []  # budget (0) spent
        assert launcher.exhausted() == [0]


def test_launch_cli_clean_exit(tmp_path) -> None:
    rc = main(["--groups", "2", "--log-dir", str(tmp_path), "--", sys.executable, "-c",
               "import os; print('done', os.environ['REPLICA_GROUP_ID'], flush=True)"])
    assert rc == 0
    for g in (0, 1):
        assert f"done {g}" in (tmp_path / f"g{g}.log").read_text()


def test_launch_cli_requires_command() -> None:
    with pytest.raises(SystemExit):
        main(["--groups", "1", "--"])


def test_launch_cli_reports_an_exhausted_budget(tmp_path) -> None:
    rc = main(["--groups", "1", "--max-restarts", "0", "--log-dir", str(tmp_path), "--",
               sys.executable, "-c", "raise SystemExit(3)"])
    assert rc == 1


def test_crash_loop_backoff(tmp_path) -> None:
    """A group that exits non-zero almost at once is restarted with
    exponential backoff, not at the supervisor's poll rate."""
    with Launcher([sys.executable, "-c", "raise SystemExit(3)"], num_groups=1,
                  lighthouse=None, max_restarts=None, log_dir=str(tmp_path)) as launcher:
        _wait(lambda: launcher._groups[0].proc.poll() is not None)
        deadline = time.monotonic() + 1.2
        while time.monotonic() < deadline:
            launcher.supervise_once()
            time.sleep(0.02)
        assert launcher.restarts(0) <= 2
        before = launcher.restarts(0)
        _wait(lambda: (launcher.supervise_once(), launcher.restarts(0) > before)[1],
              timeout=10.0)


def _status(http_address: str) -> dict:
    with urllib.request.urlopen(http_address + "/status.json", timeout=5) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("where", ["embed", "external"])
def test_kill_evicts_the_group_at_the_lighthouse(tmp_path, where) -> None:
    """kill() drops the dead group's heartbeat at once (well inside the 5 s
    heartbeat timeout): in-process for an embedded lighthouse, over wire
    method 4 for an external one.  The survivor stays."""
    external = None
    if where == "external":
        external = _native.LighthouseServer(bind="127.0.0.1:0", http_bind="127.0.0.1:0")
    try:
        lighthouse = "embed" if external is None else external.address()
        with Launcher([sys.executable, "-c", _HEARTBEATING_GROUP], num_groups=2,
                      lighthouse=lighthouse, log_dir=str(tmp_path), cwd=REPO) as launcher:
            http = (launcher.lighthouse_http_address if external is None
                    else external.http_address())
            _wait(lambda: {"0:x", "1:x"} <= set(_status(http)["heartbeat_age_ms"]))
            launcher.kill(1)
            seen = set(_status(http)["heartbeat_age_ms"])
            assert "1:x" not in seen and "0:x" in seen
    finally:
        if external is not None:
            external.shutdown()


def test_lighthouse_client_evict_over_the_wire() -> None:
    lh = _native.LighthouseServer(bind="127.0.0.1:0", http_bind="127.0.0.1:0")
    ms = _native.ManagerServer(replica_id="3:abc", lighthouse_addr=lh.address(),
                               bind="127.0.0.1:0", store_addr="127.0.0.1:1")
    client = _native.LighthouseClient(lh.address())
    try:
        _wait(lambda: "3:abc" in _status(lh.http_address())["heartbeat_age_ms"])
        assert client.evict("3") == 1
        assert client.evict("3") == 0
    finally:
        client.close()
        ms.shutdown()
        lh.shutdown()


def test_killed_group_heals_and_converges_on_cpu(tmp_path) -> None:
    """The supervised kill-and-heal drive of the example on the CPU: SIGKILL
    group 1 after merged commits, one restart, a heal after the kill, both
    FINAL lines at one step with one params_sha256, finite losses."""
    t0 = time.monotonic()
    # 1000 steps: the groups start seconds apart, and the first must not
    # reach the budget alone before both have merged (a few ms a step here).
    r = kill_and_heal("cpu", str(tmp_path), steps=1000, merged_before_kill=3, timeout_s=150.0,
                      env={"OMP_NUM_THREADS": "1"})
    assert time.monotonic() - t0 < 150.0
    assert r["restarts"] == [0, 1]
    assert r["final_step"] >= 1000
    assert 0 < r["recovery_s"] < 120.0
    # The first merged commit is the restarted incarnation's, never one the
    # killed process logged just before the kill.
    assert r["recovery_s"] > r["kill_to_restart_s"]


def test_train_ddp_resumes_both_groups_from_disk_checkpoints_on_cpu(tmp_path) -> None:
    """The example's ``--ckpt_dir``: two groups run to step 10 and stop
    (saves every 5 steps, one ``group_<g>`` directory each); a second job
    prints "resumed from disk checkpoint step=10" in both groups and ends
    both at step 20 with one params_sha256."""
    t0 = time.monotonic()
    r = stop_and_resume("cpu", str(tmp_path), steps=10, ckpt_every=5, timeout_s=150.0,
                        env={"OMP_NUM_THREADS": "1"})
    assert time.monotonic() - t0 < 150.0
    assert r["resumed_step"] == 10 and r["resumed"]["final_step"] == 20
    assert sorted(os.listdir(r["ckpt_dir"])) == ["group_0", "group_1"]
    for g in (0, 1):
        names = sorted(os.listdir(os.path.join(r["ckpt_dir"], f"group_{g}")))
        assert names == [f"step_{s:012d}.tpuft" for s in (10, 15, 20)]
    assert r["first"]["params_sha256"] != r["resumed"]["params_sha256"]


def test_tail_splits_incarnations_by_line_not_read_time(tmp_path) -> None:
    """Lines the killed process wrote after the last poll are read after the
    kill; they stay the old incarnation's, and a line the kill cut short
    does not join the next incarnation's first line."""
    path = tmp_path / "g1.log"
    tail = _Tail(str(path))
    with open(path, "ab") as f:
        f.write(b"[group 1] step=4 loss=2.3 participants=2 committed=True\n")
    tail.poll()
    with open(path, "ab") as f:  # written before the kill, read after it
        f.write(b"[group 1] step=5 loss=2.2 participants=2 committed=True\n[group 1] st")
    t_kill = time.monotonic()
    reborn = tail.close_writer()
    assert reborn == 3
    assert [s[1] for s in tail.steps(after=t_kill)] == [5]
    with open(path, "ab") as f:
        f.write(b"INFO healing from replica 0\n"
                b"[group 1] step=6 loss=2.1 participants=2 committed=True\n")
    tail.poll()
    assert [s[1] for s in tail.steps(first=reborn)] == [6]
    assert tail.count("healing from replica", first=reborn) == 1
    assert tail.lines[reborn - 1][1] == "[group 1] st"


# -- hot spares ---------------------------------------------------------------------

# tests/test_launch.py's spare-aware child: a spare blocks on its go-file.
_SPARE_AWARE = (
    "import os,time;"
    "gid = os.environ.get('REPLICA_GROUP_ID');"
    "sf = os.environ.get('TPUFT_SPARE_FILE');\n"
    "if gid is None and sf:\n"
    "    print('spare ready', flush=True)\n"
    "    while not os.path.exists(sf): time.sleep(0.02)\n"
    "    gid = open(sf).read().strip()\n"
    "print('gid', gid, flush=True); time.sleep(60)"
)


def _launcher_cls(which: str):
    if which == "port":
        return Launcher
    return import_reference("torchft_tpu.launch").Launcher


@pytest.mark.parametrize("which", ["port", "jax"])
def test_hot_spare_adoption(tmp_path, which) -> None:
    """A killed group restarts by adopting the ready spare (the group's
    process is the former spare's), and the pool is refilled."""
    with _launcher_cls(which)([sys.executable, "-c", _SPARE_AWARE], num_groups=1,
                              lighthouse=None, max_restarts=3, log_dir=str(tmp_path),
                              spares=1) as launcher:
        _wait(lambda: b"gid 0" in (tmp_path / "g0.log").read_bytes())
        _wait(lambda: launcher.spare_count() == 1)
        spare_pid, spare_sid = launcher._spares[0].proc.pid, launcher._spares[0].sid
        _wait(lambda: b"spare ready" in (tmp_path / f"spare_{spare_sid}.log").read_bytes())
        launcher.kill(0, hold=False)
        assert launcher.supervise_once() == [0]
        assert launcher._groups[0].proc.pid == spare_pid
        assert launcher.restarts(0) == 1
        _wait(lambda: b"gid 0" in (tmp_path / f"spare_{spare_sid}.log").read_bytes())
        _wait(lambda: launcher.spare_count() == 1)
        assert launcher._spares[0].sid != spare_sid
    assert not list(tmp_path.glob("spare_*.go"))


@pytest.mark.parametrize("which", ["port", "jax"])
def test_dead_spare_is_refilled_and_fast_deaths_disable_the_pool(tmp_path, which) -> None:
    """A spare that dies after a healthy uptime is replaced; a command whose
    spares die at once stops the pool after four fast deaths, and the
    groups then restart cold."""
    cls = _launcher_cls(which)
    with cls([sys.executable, "-c", _SPARE_AWARE], num_groups=1, lighthouse=None,
             log_dir=str(tmp_path / "a"), spares=1) as launcher:
        _wait(lambda: launcher.spare_count() == 1)
        first = launcher._spares[0]
        first.spawned_at -= 60.0  # a healthy uptime
        first.proc.kill()
        first.proc.wait()
        launcher.supervise_once()
        _wait(lambda: launcher.spare_count() == 1)
        assert launcher._spares[0].sid != first.sid
        assert not launcher._spare_pool_disabled

    crash = "import os,sys; sys.exit(3) if 'TPUFT_SPARE_FILE' in os.environ else None;" + \
        "print('gid', os.environ['REPLICA_GROUP_ID'], flush=True); import time; time.sleep(60)"
    with cls([sys.executable, "-c", crash], num_groups=1, lighthouse=None,
             log_dir=str(tmp_path / "b"), max_restarts=2, spares=1) as launcher:
        deadline = time.monotonic() + 60
        while not launcher._spare_pool_disabled:
            assert time.monotonic() < deadline, "the pool was never disabled"
            launcher.supervise_once()
            time.sleep(0.05)
        assert launcher.spare_count() == 0
        group_pid = launcher._groups[0].proc.pid
        launcher.kill(0, hold=False)
        assert launcher.supervise_once() == [0]
        assert launcher._groups[0].proc.pid != group_pid
        _wait(lambda: (tmp_path / "b" / "g0.log").read_bytes().count(b"gid 0") == 2)


@pytest.mark.parametrize("which", ["port", "jax"])
def test_group_with_its_own_env_spawns_cold(tmp_path, which) -> None:
    """Spares start with the base environment only, so a group with
    overrides of its own restarts cold and leaves the spare in the pool."""
    with _launcher_cls(which)([sys.executable, "-c", _SPARE_AWARE], num_groups=1,
                              lighthouse=None, log_dir=str(tmp_path), spares=1) as launcher:
        _wait(lambda: launcher.spare_count() == 1)
        _wait(lambda: b"gid 0" in (tmp_path / "g0.log").read_bytes())
        spare_pid = launcher._spares[0].proc.pid
        launcher._groups[0].env = {"EXTRA": "1"}
        launcher.kill(0, hold=False)
        assert launcher.supervise_once() == [0]
        assert launcher._groups[0].proc.pid != spare_pid
        assert launcher.spare_count() == 1 and launcher._spares[0].proc.pid == spare_pid
        _wait(lambda: (tmp_path / "g0.log").read_bytes().count(b"gid 0") == 2)


def test_launch_cli_spares(tmp_path) -> None:
    """``--spares 1``: the CLI's groups finish cleanly with a spare in the
    pool, and the spare is stopped with the launcher."""
    rc = main(["--groups", "1", "--spares", "1", "--log-dir", str(tmp_path), "--",
               sys.executable, "-c",
               "import os,time\nif 'TPUFT_SPARE_FILE' in os.environ: time.sleep(60)\n"
               "else: time.sleep(1.0); print('done', os.environ['REPLICA_GROUP_ID'])"])
    assert rc == 0
    assert b"done 0" in (tmp_path / "g0.log").read_bytes()
    assert (tmp_path / "spare_0.log").exists() and not list(tmp_path.glob("spare_*.go"))
