"""Replica-group launcher and restart supervisor.

The counterpart of ``torchft_tpu/launch.py``; ``--dump-spec`` prints the
job as a GPU JobSet manifest (``spec.py``) instead of launching it.
``Launcher`` starts one process per replica group with the environment
contract every group reads (``REPLICA_GROUP_ID``, ``NUM_REPLICA_GROUPS``,
``TPUFT_LIGHTHOUSE``, ``MASTER_ADDR``, ``TPUFT_DRAIN_DIR``), optionally
runs the native lighthouse in-process, and restarts a group that died: the
new process is a new incarnation that rejoins through the lighthouse and
heals from a live peer.
A dead or killed group is evicted at the lighthouse once per incarnation,
so the survivors' next quorum does not wait out the heartbeat timeout, and
a group that dies within seconds of its start is restarted with
exponential backoff instead of at the supervisor's poll rate.

Hot spares (``spares=N``, ``--spares N``): processes started with no
``REPLICA_GROUP_ID`` and a go-file (``TPUFT_SPARE_FILE``) pay for their
start while idle; a restart hands the dead group's id to a ready spare by
writing its go-file, and the pool is refilled.  Cooperative drain
(:meth:`Launcher.drain`, or an operator's ``drain_<g>.json`` in the log
directory): the group's id goes to a replacement at once while the donor,
told through its pid-pinned notice file, finishes its step and exits;
past its deadline it is sent SIGTERM, then SIGKILL.

Detect and act, with an embedded lighthouse: the straggler sentinel
(``straggler_auto_drain``, ``TPUFT_STRAGGLER_AUTO_DRAIN=1``) rotates a
group that the lighthouse's ``/alerts.json`` names a straggler out
through :meth:`Launcher.drain`; the incident watcher (``incident_watcher``,
``--incident-watcher``, ``TPUFT_INCIDENT_WATCHER=1``) captures an evidence
bundle for each trigger on ``/incident.json`` and journals what it
recommends to ``watcher_journal.jsonl`` in the log directory, acting (a
drain) only with ``watcher_act`` (``--watcher-act``, ``TPUFT_WATCHER_ACT=1``).

CLI::

    python -m torchft_tpu_torch.launch --groups 2 --spares 1 --max-restarts 3 -- \\
        python -m torchft_tpu_torch.examples.train_ddp --steps 150

Programmatic::

    with Launcher([sys.executable, "train.py"], num_groups=2,
                  lighthouse="embed", log_dir=workdir) as launcher:
        while launcher.running():
            time.sleep(0.25)
            launcher.supervise_once()
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from torchft_tpu_torch.metrics import MetricsLogger

logger = logging.getLogger(__name__)

# A group that exits in under this many seconds is treated as crash-looping
# and restarted with exponential backoff rather than at once.
_MIN_UPTIME_S = 5.0

__all__ = ["Launcher", "fetch_alerts", "main"]


def fetch_alerts(http_address: str, timeout: float = 2.0) -> Optional[dict]:
    """The lighthouse's alert feed (``GET /alerts.json``) from a
    ``host:port`` HTTP address, or None on any failure: the callers poll
    inside supervision or measurement loops, where a missed fetch means
    "later".  Dials 127.0.0.1 at the advertised port (an embedded
    lighthouse binds loopback, and the advertised host name may not
    resolve)."""
    import urllib.request

    if not http_address:
        return None
    port = http_address.rsplit(":", 1)[-1]
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/alerts.json",
                                    timeout=timeout) as resp:
            return json.loads(resp.read().decode())
    except Exception:  # noqa: BLE001 - see the docstring
        return None


@dataclass
class _Spare:
    """A started process with no group id, blocked in the example's
    ``replica_env`` until its go-file names one."""

    proc: subprocess.Popen
    log: Optional[object]
    go_path: str
    sid: int
    spawned_at: float = 0.0


@dataclass
class _Draining:
    """A donor finishing a cooperative departure: out of its group's slot
    (the replacement holds it), reaped on its own, and sent SIGTERM, then
    SIGKILL, past its deadline."""

    proc: subprocess.Popen
    log: Optional[object]
    group: int
    deadline: float  # monotonic
    notice_path: str
    started: float = 0.0
    term_sent: bool = False


@dataclass
class _Group:
    proc: Optional[subprocess.Popen] = None
    log: Optional[object] = None
    restarts: int = 0
    held: bool = False  # killed on purpose; not restarted until spawn()
    exited_clean: bool = False
    # Environment overrides of this group alone: such a group cannot adopt
    # a spare (spares start with the base environment) and spawns cold.
    env: Dict[str, str] = field(default_factory=dict)
    spawned_at: float = 0.0
    # Crash-loop brake: the next restart waits until backoff_until.
    backoff_until: float = 0.0
    backoff_s: float = 0.0
    # The death was our kill(): exempt from the brake.
    killed_by_us: bool = False
    # This incarnation's death was already reported to the lighthouse (dead
    # groups are polled every pass; the evict must not repeat each tick).
    evicted: bool = False


class Launcher:
    """Launches and supervises ``num_groups`` replica-group processes.

    Args:
        cmd: argv of one replica group.
        num_groups: number of replica groups (``NUM_REPLICA_GROUPS``).
        lighthouse: ``"embed"`` to run the native lighthouse in-process, a
            ``"host:port"`` of an external one, or None to inherit
            ``TPUFT_LIGHTHOUSE`` from the environment.
        max_restarts: per-group restart budget (None: unlimited).
        min_replicas: the embedded lighthouse's quorum floor.
        join_timeout_ms: the embedded lighthouse's straggler wait.
        log_dir: each group appends to ``<log_dir>/g<i>.log``; None
            inherits this process's stdout and stderr.
        env: extra environment for every group (a None value unsets).
        cwd: working directory of the groups.
        spares: hot-spare pool size.  The command must resolve its group
            id through the examples' ``replica_env`` contract.
        straggler_auto_drain: act on the lighthouse's straggler alerts
            (embedded lighthouse only): :meth:`supervise_once` polls
            ``/alerts.json`` and rotates a confirmed straggler out through
            :meth:`drain`, so a degraded-but-alive host costs one handoff
            instead of slowing every synchronous step for the rest of the
            job.  Default: ``TPUFT_STRAGGLER_AUTO_DRAIN=1``.
        incident_watcher: run the incident watcher (embedded lighthouse
            only): bundles and ``watcher_journal.jsonl`` in the log
            directory.  Default: ``TPUFT_INCIDENT_WATCHER=1``.
        watcher_act: let the watcher execute its one actionable policy,
            a drain through :meth:`drain`; dry-run otherwise.  Default:
            ``TPUFT_WATCHER_ACT=1``.
    """

    def __init__(
        self,
        cmd: List[str],
        num_groups: int,
        *,
        lighthouse: Optional[str] = None,
        max_restarts: Optional[int] = None,
        min_replicas: int = 1,
        join_timeout_ms: int = 2000,
        log_dir: Optional[str] = None,
        env: Optional[Dict[str, Optional[str]]] = None,
        cwd: Optional[str] = None,
        spares: int = 0,
        straggler_auto_drain: Optional[bool] = None,
        incident_watcher: Optional[bool] = None,
        watcher_act: Optional[bool] = None,
    ) -> None:
        self._cmd = list(cmd)
        self._num_groups = num_groups
        self._max_restarts = max_restarts
        self._log_dir = log_dir
        self._cwd = cwd
        self._groups: Dict[int, _Group] = {i: _Group() for i in range(num_groups)}
        self._embedded = None
        self._evict_client = None  # wire client of an external lighthouse
        self._spares_target = max(0, spares)
        self._spares: List[_Spare] = []
        self._spare_seq = 0
        self._spare_fast_deaths = 0
        self._spare_pool_disabled = False
        self._draining: List[_Draining] = []
        if straggler_auto_drain is None:
            straggler_auto_drain = os.environ.get("TPUFT_STRAGGLER_AUTO_DRAIN", "") == "1"
        self._straggler_auto_drain = straggler_auto_drain
        self._sentinel_last_poll = 0.0
        self._handled_alerts: set = set()
        if incident_watcher is None:
            incident_watcher = os.environ.get("TPUFT_INCIDENT_WATCHER", "") == "1"
        if watcher_act is None:
            watcher_act = os.environ.get("TPUFT_WATCHER_ACT", "") == "1"
        self._incident_watcher_enabled = incident_watcher
        self._watcher_act = watcher_act
        self._watcher = None  # built at the first supervise pass
        self.lighthouse_http_address = ""
        if lighthouse == "embed":
            from torchft_tpu_torch._native import LighthouseServer

            self._embedded = LighthouseServer(
                bind="127.0.0.1:0", http_bind="127.0.0.1:0",
                min_replicas=min_replicas, join_timeout_ms=join_timeout_ms,
            )
            self.lighthouse_address = self._embedded.address()
            self.lighthouse_http_address = self._embedded.http_address()
        elif lighthouse is not None:
            self.lighthouse_address = lighthouse
        else:
            self.lighthouse_address = os.environ.get("TPUFT_LIGHTHOUSE", "")

        base = dict(os.environ)
        for k, v in (env or {}).items():
            if v is None:
                base.pop(k, None)
            else:
                base[k] = v
        base["NUM_REPLICA_GROUPS"] = str(num_groups)
        base["MASTER_ADDR"] = base.get("MASTER_ADDR", "localhost")
        if self.lighthouse_address:
            base["TPUFT_LIGHTHOUSE"] = self.lighthouse_address
        # The drain channel and the spares' go-files: the log directory, or
        # a temporary one removed at stop().  Children honour only notices
        # pinned to their pid; a pid-less file is an operator's request to
        # this supervisor, which re-issues it through drain().
        self._work_dir_created = log_dir is None
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            self._work_dir = log_dir
        else:
            self._work_dir = tempfile.mkdtemp(prefix="tpuft_launch_")
        base["TPUFT_DRAIN_DIR"] = self._work_dir
        base["TPUFT_DRAIN_SUPERVISED"] = "1"
        self._base_env = base
        self._metrics = MetricsLogger(base.get("TPUFT_METRICS_PATH"), "launcher")

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Launcher":
        for i in range(self._num_groups):
            self.spawn(i)
        for _ in range(self._spares_target):
            self._spawn_spare()
        return self

    # -- hot spares ------------------------------------------------------------

    def _spawn_spare(self) -> None:
        if self._spare_pool_disabled:
            return
        sid = self._spare_seq
        self._spare_seq += 1
        go_path = os.path.join(self._work_dir, f"spare_{sid}.go")
        env = dict(self._base_env)
        env.pop("REPLICA_GROUP_ID", None)
        env["TPUFT_SPARE_FILE"] = go_path
        stdout = stderr = log = None
        if self._log_dir is not None:
            log = open(os.path.join(self._log_dir, f"spare_{sid}.log"), "ab")
            stdout, stderr = log, subprocess.STDOUT
        proc = subprocess.Popen(self._cmd, env=env, stdout=stdout, stderr=stderr, cwd=self._cwd)
        self._spares.append(_Spare(proc=proc, log=log, go_path=go_path, sid=sid,
                                   spawned_at=time.monotonic()))

    def _note_spare_death(self, spare: _Spare) -> None:
        """A dead spare: close its log, count a fast death (more than three
        in a row disable the pool: the command itself is broken), refill."""
        if spare.log is not None:
            spare.log.close()
        if time.monotonic() - spare.spawned_at < _MIN_UPTIME_S:
            self._spare_fast_deaths += 1
        else:
            self._spare_fast_deaths = 0
        if self._spare_fast_deaths > 3:
            self._spare_pool_disabled = True
            logger.error("spare %d died fast (exit %s); pool disabled after repeated "
                         "immediate deaths", spare.sid, spare.proc.poll())
            return
        logger.warning("spare %d died (exit %s); respawning", spare.sid, spare.proc.poll())
        self._spawn_spare()

    def _take_ready_spare(self) -> Optional[_Spare]:
        while self._spares:
            spare = self._spares.pop(0)
            if spare.proc.poll() is None:
                return spare
            self._note_spare_death(spare)  # replaced, or the pool shrinks to zero
        return None

    def spare_count(self) -> int:
        """Live spares in the pool."""
        return sum(1 for s in self._spares if s.proc.poll() is None)

    def __enter__(self) -> "Launcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def spawn(self, group: int) -> None:
        """(Re)starts one replica group; clears any kill-hold on it.  With a
        hot-spare pool the group adopts a ready spare (the process that was
        the spare goes on as the group) instead of starting cold."""
        g = self._groups[group]
        if g.proc is not None and g.proc.poll() is None:
            raise RuntimeError(f"group {group} is already running")
        g.held = False
        g.exited_clean = False
        g.backoff_until = 0.0  # an explicit spawn overrides a pending backoff
        g.killed_by_us = False
        g.evicted = False  # a new incarnation: its death is unreported
        spare = self._take_ready_spare() if self._spares_target and not g.env else None
        if spare is not None:
            tmp = spare.go_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(group))
            os.replace(tmp, spare.go_path)  # atomic: the spare reads a whole id
            if g.log is not None:
                g.log.close()
            g.proc, g.log = spare.proc, spare.log  # it keeps its spare log
            g.spawned_at = time.monotonic()
            logger.info("group %d adopted hot spare %d (pid %d)", group, spare.sid,
                        spare.proc.pid)
            self._spawn_spare()
            return
        env = dict(self._base_env)
        env["REPLICA_GROUP_ID"] = str(group)
        env.update(g.env)
        stdout = stderr = None
        if self._log_dir is not None:
            if g.log is not None:
                g.log.close()
            g.log = open(os.path.join(self._log_dir, f"g{group}.log"), "ab")
            stdout, stderr = g.log, subprocess.STDOUT
        g.proc = subprocess.Popen(self._cmd, env=env, stdout=stdout, stderr=stderr, cwd=self._cwd)
        g.spawned_at = time.monotonic()

    def _evict_from_lighthouse(self, group: int) -> None:
        """Tells the lighthouse the group's incarnations are dead, so the
        next quorum forms without waiting on their still-fresh heartbeats:
        in-process for an embedded lighthouse, over the wire (method 4)
        otherwise, failing over across an HA replica list.  A failed evict only costs the survivors the heartbeat
        timeout, so it is logged, not raised."""
        try:
            if self._embedded is not None:
                self._embedded.evict(str(group))
            elif self.lighthouse_address:
                from torchft_tpu_torch._native import LighthouseClient

                if self._evict_client is None:
                    self._evict_client = LighthouseClient(self.lighthouse_address)
                self._evict_client.evict(str(group))
        except Exception:  # noqa: BLE001 - see the docstring
            if self._evict_client is not None:
                self._evict_client.close()
            self._evict_client = None  # redial at the next death
            logger.warning("lighthouse evict of group %d failed", group, exc_info=True)

    def _drain_at_lighthouse(self, group: int, deadline_ms: int) -> None:
        """Marks the group's existing incarnations draining at the
        lighthouse (by family prefix, before the replacement exists, so its
        fresh id is not caught): the next quorum leaves them out even when
        the child never wired the drain contract."""
        try:
            if self._embedded is not None:
                self._embedded.drain(str(group), deadline_ms)
            elif self.lighthouse_address:
                from torchft_tpu_torch._native import LighthouseClient

                if self._evict_client is None:
                    self._evict_client = LighthouseClient(self.lighthouse_address)
                self._evict_client.drain(str(group), deadline_ms)
        except Exception:  # noqa: BLE001 - the donor's own notice still reaches it
            if self._evict_client is not None:
                self._evict_client.close()
            self._evict_client = None
            logger.warning("lighthouse drain of group %d failed", group, exc_info=True)

    def drain(self, group: int, deadline_s: float = 30.0) -> None:
        """Cooperative drain of one group: the donor is told through its
        pid-pinned notice file and marked draining at the lighthouse, and
        the group's id goes to a replacement at once (a ready hot spare, or
        a cold start), so the replacement's start overlaps the donor's last
        step.  :meth:`supervise_once` reaps the donor, and past
        ``deadline_s`` sends it SIGTERM, then SIGKILL."""
        g = self._groups[group]
        if g.proc is None or g.proc.poll() is not None:
            raise RuntimeError(f"group {group} is not running; nothing to drain")
        donor = g.proc
        notice_path = os.path.join(self._work_dir, f"drain_{group}.json")
        tmp = notice_path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"deadline_ms": int(deadline_s * 1000), "source": "supervisor",
                       "pid": donor.pid}, f)
        os.replace(tmp, notice_path)  # atomic: the watcher reads whole notices
        self._drain_at_lighthouse(group, int(deadline_s * 1000))
        now = time.monotonic()
        self._draining.append(_Draining(proc=donor, log=g.log, group=group,
                                        deadline=now + deadline_s, notice_path=notice_path,
                                        started=now))
        g.proc = g.log = None
        hot = self._spares_target > 0 and self.spare_count() > 0 and not g.env
        self.spawn(group)
        logger.info("group %d draining (pid %d, deadline %.1fs); replacement %s", group,
                    donor.pid, deadline_s, "adopted a hot spare" if hot else "cold-spawned")
        self._metrics.emit("drain_handoff", group=str(group), donor_pid=donor.pid,
                           hot_spare=hot, deadline_ms=int(deadline_s * 1000))

    def draining(self) -> List[int]:
        """Groups whose donor is still finishing a cooperative departure."""
        return sorted({d.group for d in self._draining if d.proc.poll() is None})

    def kill(self, group: int, sig: int = signal.SIGKILL, hold: bool = True) -> None:
        """Kills one group (SIGKILL by default: fault injection) and evicts
        it at the lighthouse.  With ``hold`` the supervisor does not restart
        it until :meth:`spawn`."""
        g = self._groups[group]
        if g.proc is not None and g.proc.poll() is None:
            g.proc.send_signal(sig)
            g.proc.wait()
            # Only a death we caused is exempt from the crash-loop brake.
            g.killed_by_us = True
            g.backoff_s = 0.0
            g.evicted = True
            self._evict_from_lighthouse(group)
        g.held = hold

    def supervise_once(self) -> List[int]:
        """One supervision pass: restarts the groups that died (not held),
        unless they exited cleanly or spent ``max_restarts``.  Returns the
        groups restarted in this pass."""
        restarted: List[int] = []
        for i, g in self._groups.items():
            if g.proc is None or g.held or g.exited_clean:
                continue
            code = g.proc.poll()
            if code is None:
                continue
            # Evict before the budget check: a group with no restarts left
            # is the most permanently dead of all.
            if not g.evicted:
                g.evicted = True
                self._evict_from_lighthouse(i)
            if code == 0:
                g.exited_clean = True
                continue
            if self._max_restarts is not None and g.restarts >= self._max_restarts:
                continue
            now = time.monotonic()
            if g.killed_by_us:
                g.killed_by_us = False
                g.backoff_until = 0.0
            elif g.backoff_until:
                if now < g.backoff_until:
                    continue
                g.backoff_until = 0.0  # backoff served: restart below
            else:
                uptime = now - g.spawned_at
                if uptime < _MIN_UPTIME_S:
                    # Died almost at once: double the delay before the next
                    # attempt (0.5 s up to 30 s).
                    g.backoff_s = min(30.0, max(0.5, g.backoff_s * 2))
                    g.backoff_until = now + g.backoff_s
                    logger.warning(
                        "group %d exited with code %s after %.2fs; backing off %.1fs "
                        "before restart %d", i, code, uptime, g.backoff_s, g.restarts + 1,
                    )
                    continue
                g.backoff_s = 0.0  # a healthy uptime resets the brake
            logger.info("group %d exited with code %s; restarting (restart %d)",
                        i, code, g.restarts + 1)
            g.restarts += 1
            self.spawn(i)
            restarted.append(i)
        self._operator_drains()
        self._reap_draining()
        for spare in list(self._spares):
            if spare.proc.poll() is not None:
                self._spares.remove(spare)
                self._note_spare_death(spare)
        self._sentinel_once()
        self._watcher_once()
        return restarted

    def _drain_or_refill(self, group: int) -> None:
        """:meth:`drain`, or where the donor already left (the lighthouse's
        own drain mark aborts its quorum joins, and a cooperative Manager
        exits cleanly on that) a replacement for the slot."""
        try:
            self.drain(group, deadline_s=30.0)
        except RuntimeError:
            g = self._groups[group]
            if g.proc is None or g.proc.poll() is not None:
                self.spawn(group)

    def _sentinel_once(self) -> None:
        """Acts on the lighthouse's straggler alerts (``/alerts.json``,
        polled at most once a second): an active, unhandled ``straggler``
        alert for a group of this supervisor rotates it out through the
        cooperative drain.  The lighthouse detects (it sees every group's
        pace), the supervisor acts (it owns the spares).  While a configured
        spare pool is empty the alert is left for the next poll: rotating
        without a warm replacement trades a slow step for a cold start."""
        if not self._straggler_auto_drain or not self.lighthouse_http_address:
            return
        now = time.monotonic()
        if now - self._sentinel_last_poll < 1.0:
            return
        self._sentinel_last_poll = now
        alerts = fetch_alerts(self.lighthouse_http_address)
        if alerts is None:
            return  # a missed poll; the next one retries
        for alert in alerts.get("alerts", []):
            if not alert.get("active") or alert.get("kind") != "straggler":
                continue
            if alert.get("id") in self._handled_alerts:
                continue
            try:
                group = int(str(alert.get("replica_id", "")).split(":", 1)[0])
            except ValueError:
                continue
            if group not in self._groups:
                continue
            g = self._groups[group]
            # The alert names an incarnation; the slot may hold a younger
            # process (the alerted one died and was replaced before its
            # alert resolved), which must not be drained over it.  The
            # clocks differ (the alert's epoch ms, the spawn's monotonic
            # time), so compare ages, with 1 s of slack for the skew.
            alert_age = time.time() - float(alert.get("raised_ms", 0)) / 1e3
            proc_age = now - g.spawned_at if g.proc is not None else float("inf")
            if proc_age + 1.0 < alert_age:
                self._handled_alerts.add(alert.get("id"))  # stale: never act
                continue
            if self._spares_target > 0 and self.spare_count() == 0:
                continue  # the pool is refilling; retried at the next poll
            self._handled_alerts.add(alert.get("id"))
            logger.warning("group %d (%s) confirmed straggler (%.2fx median, step time %.0f ms); "
                           "rotating out via cooperative drain", group, alert.get("replica_id"),
                           float(alert.get("ratio", 0.0)), float(alert.get("step_time_ms", 0.0)))
            self._metrics.emit("straggler_drain", group=str(group),
                               replica_id=alert.get("replica_id"), alert_id=alert.get("id"),
                               ratio=alert.get("ratio"), step_time_ms=alert.get("step_time_ms"))
            self._drain_or_refill(group)

    def _watcher_once(self) -> None:
        """One incident-watcher pass (built at the first call, throttled by
        the watcher itself): bundles and ``watcher_journal.jsonl`` in the
        log directory; its one action, a drain, goes through
        :meth:`drain`, so the departing group gets a replacement.  A
        failing pass is logged: the watcher never takes the run down."""
        if not self._incident_watcher_enabled or not self.lighthouse_http_address:
            return
        try:
            if self._watcher is None:
                from torchft_tpu_torch.obs.watcher import IncidentWatcher

                def drain_group(target: str) -> None:
                    group = int(target)
                    if group not in self._groups:
                        raise ValueError(f"unknown group {target}")
                    self._drain_or_refill(group)

                metrics_path = self._base_env.get("TPUFT_METRICS_PATH")
                self._watcher = IncidentWatcher(
                    [self.lighthouse_http_address], self._work_dir, act=self._watcher_act,
                    metrics_paths=[metrics_path] if metrics_path else [],
                    drain_cb=drain_group)
            self._watcher.poll_once()
        except Exception:  # noqa: BLE001 - see the docstring
            logger.exception("incident watcher poll failed")

    def _operator_drains(self) -> None:
        """A pid-less ``drain_<g>.json`` in the drain directory (an
        operator's ``echo '{}' > <log-dir>/drain_1.json``) is a request to
        this supervisor: re-issued through :meth:`drain`, which starts the
        replacement and pins the notice to the donor's pid."""
        for i, g in self._groups.items():
            if g.proc is None or g.proc.poll() is not None:
                continue
            try:
                with open(os.path.join(self._work_dir, f"drain_{i}.json"), "rb") as f:
                    raw = f.read()
            except OSError:
                continue  # absent, or consumed by its donor
            deadline_s = 30.0
            try:
                data = json.loads(raw)
                if data.get("pid") is not None:
                    continue  # pinned: on its way to its donor
                deadline_s = float(data.get("deadline_ms", 30000)) / 1000.0
            except (ValueError, AttributeError):
                pass  # a bare touch is a valid request
            logger.info("group %d: operator drain request", i)
            self.drain(i, deadline_s=deadline_s)

    def _reap_draining(self) -> None:
        """Reaps donors that finished their departure; escalates SIGTERM,
        then SIGKILL 5 s later, to one still alive past its deadline."""
        for d in list(self._draining):
            code = d.proc.poll()
            now = time.monotonic()
            if code is not None:
                self._draining.remove(d)
                if d.log is not None:
                    d.log.close()
                try:
                    os.remove(d.notice_path)
                except OSError:
                    pass
                logger.info("group %d donor (pid %d) exited %s after %.2fs of drain", d.group,
                            d.proc.pid, code, now - d.started)
                self._metrics.emit("drain_donor_exit", group=str(d.group), exit_code=code,
                                   drain_s=round(now - d.started, 3))
            elif now > d.deadline:
                if not d.term_sent:
                    logger.warning("group %d donor (pid %d) alive past its drain deadline; "
                                   "SIGTERM", d.group, d.proc.pid)
                    d.proc.send_signal(signal.SIGTERM)
                    d.term_sent = True
                    d.deadline = now + 5.0
                else:
                    logger.warning("group %d donor (pid %d) ignored SIGTERM; SIGKILL", d.group,
                                   d.proc.pid)
                    d.proc.kill()

    def pid(self, group: int) -> Optional[int]:
        """PID of the group's current process (None while it is dead)."""
        g = self._groups[group]
        if g.proc is not None and g.proc.poll() is None:
            return g.proc.pid
        return None

    def running(self) -> bool:
        """True while any group process is alive."""
        return any(g.proc is not None and g.proc.poll() is None for g in self._groups.values())

    def all_exited_clean(self) -> bool:
        return all(g.exited_clean for g in self._groups.values())

    def exhausted(self) -> List[int]:
        """Groups that died with no restart budget left."""
        out = []
        for i, g in self._groups.items():
            if g.exited_clean or g.held or g.proc is None:
                continue
            code = g.proc.poll()
            if (code is not None and code != 0 and self._max_restarts is not None
                    and g.restarts >= self._max_restarts):
                out.append(i)
        return out

    def restarts(self, group: int) -> int:
        return self._groups[group].restarts

    def stop(self) -> None:
        """SIGTERM every group, SIGKILL what is left after 10 s and every
        spare and draining donor at once; close the logs, the go-files, the
        drain notices and the embedded lighthouse."""
        for g in self._groups.values():
            if g.proc is not None and g.proc.poll() is None:
                g.proc.send_signal(signal.SIGTERM)
        for proc in [d.proc for d in self._draining] + [s.proc for s in self._spares]:
            if proc.poll() is None:
                proc.kill()
        for g in self._groups.values():
            if g.proc is not None:
                try:
                    g.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    g.proc.kill()
                    g.proc.wait(timeout=5)
            if g.log is not None:
                g.log.close()
                g.log = None
        for item in self._spares + self._draining:
            try:
                item.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                pass
            if item.log is not None:
                item.log.close()
        self._spares.clear()
        self._draining.clear()
        if self._work_dir_created:
            shutil.rmtree(self._work_dir, ignore_errors=True)
        else:
            for pattern in ("spare_*.go", "drain_*.json"):
                for path in glob.glob(os.path.join(self._work_dir, pattern)):
                    try:
                        os.remove(path)
                    except OSError:
                        pass
        self._metrics.close()
        if self._evict_client is not None:
            self._evict_client.close()
            self._evict_client = None
        if self._embedded is not None:
            self._embedded.shutdown()
            self._embedded = None


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m torchft_tpu_torch.launch --groups N -- <cmd>``."""
    parser = argparse.ArgumentParser(
        prog="python -m torchft_tpu_torch.launch",
        description="Launch N fault-tolerant replica groups under a restart supervisor.",
    )
    parser.add_argument("--groups", type=int, default=2, help="replica groups")
    parser.add_argument("--max-restarts", type=int, default=None,
                        help="per-group restart budget")
    parser.add_argument("--lighthouse", default="embed",
                        help='"embed" (an in-process native lighthouse) or host:port')
    parser.add_argument("--min-replicas", type=int, default=1)
    parser.add_argument("--join-timeout-ms", type=int, default=2000)
    parser.add_argument("--spares", type=int, default=0,
                        help="hot spares: started processes that adopt a dead or draining "
                        "group's id (they skip the start and the device's init)")
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("--incident-watcher", action="store_true",
                        help="run the incident watcher against the embedded lighthouse: "
                        "bundles and watcher_journal.jsonl in the log dir; dry-run unless "
                        "--watcher-act (also TPUFT_INCIDENT_WATCHER=1)")
    parser.add_argument("--watcher-act", action="store_true",
                        help="let the watcher execute its one actionable policy (a "
                        "cooperative drain); the rest stays dry-run (also TPUFT_WATCHER_ACT=1)")
    spec = parser.add_argument_group(
        "scheduler spec generation",
        "--dump-spec renders the same env contract as a GKE JobSet manifest (one GPU Job per "
        "replica group + a lighthouse) instead of launching locally")
    spec.add_argument("--dump-spec", action="store_true",
                      help="print a JobSet YAML manifest for this job and exit")
    spec.add_argument("--name", default="tpuft", help="JobSet name")
    spec.add_argument("--hosts-per-group", type=int, default=1,
                      help="hosts per replica group (TPUFT_NUM_HOSTS)")
    spec.add_argument("--image", default="REPLACE_ME_IMAGE")
    spec.add_argument("--gpu-accelerator", default="nvidia-h100-80gb",
                      help="the GPU node label (cloud.google.com/gke-accelerator)")
    spec.add_argument("--gpus-per-host", type=int, default=8,
                      help="nvidia.com/gpu each worker pod asks for")
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- <command of one replica group>")
    args = parser.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        parser.error("missing replica-group command (after --)")

    if args.dump_spec:
        from torchft_tpu_torch.spec import dump_yaml, jobset_spec

        print(dump_yaml(jobset_spec(
            cmd, name=args.name, num_groups=args.groups, hosts_per_group=args.hosts_per_group,
            image=args.image, gpu_accelerator=args.gpu_accelerator,
            gpus_per_host=args.gpus_per_host,
            max_restarts=args.max_restarts if args.max_restarts is not None else 10,
            min_replicas=args.min_replicas)), end="")
        return 0

    launcher = Launcher(
        cmd, args.groups, lighthouse=args.lighthouse, max_restarts=args.max_restarts,
        min_replicas=args.min_replicas, join_timeout_ms=args.join_timeout_ms,
        log_dir=args.log_dir, spares=args.spares,
        incident_watcher=args.incident_watcher or None, watcher_act=args.watcher_act or None,
    )
    with launcher:
        print(f"[launch] {args.groups} groups, lighthouse="
              f"{launcher.lighthouse_address or '(inherited)'}", flush=True)
        try:
            while True:
                time.sleep(0.25)
                launcher.supervise_once()
                if launcher.all_exited_clean():
                    return 0
                if launcher.exhausted():
                    print(f"[launch] groups {launcher.exhausted()} exhausted their restart "
                          "budget", file=sys.stderr, flush=True)
                    return 1
        except KeyboardInterrupt:
            return 130


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(main())
