"""Replica-group launcher and restart supervisor.

The counterpart of ``torchft_tpu/launch.py``, cut to what the kill-and-heal
path needs.  ``Launcher`` starts one process per replica group with the
environment contract every group reads (``REPLICA_GROUP_ID``,
``NUM_REPLICA_GROUPS``, ``TPUFT_LIGHTHOUSE``, ``MASTER_ADDR``), optionally
runs the native lighthouse in-process, and restarts a group that died: the
new process is a new incarnation that rejoins through the lighthouse and
heals from a live peer.  A dead or killed group is evicted at the lighthouse
once per incarnation, so the survivors' next quorum does not wait out the
heartbeat timeout, and a group that dies within seconds of its start is
restarted with exponential backoff instead of at the supervisor's poll rate.

CLI::

    python -m torchft_tpu_torch.launch --groups 2 --max-restarts 3 -- \\
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
import logging
import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

# A group that exits in under this many seconds is treated as crash-looping
# and restarted with exponential backoff rather than at once.
_MIN_UPTIME_S = 5.0

__all__ = ["Launcher", "main"]


@dataclass
class _Group:
    proc: Optional[subprocess.Popen] = None
    log: Optional[object] = None
    restarts: int = 0
    held: bool = False  # killed on purpose; not restarted until spawn()
    exited_clean: bool = False
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
    ) -> None:
        self._cmd = list(cmd)
        self._num_groups = num_groups
        self._max_restarts = max_restarts
        self._log_dir = log_dir
        self._cwd = cwd
        self._groups: Dict[int, _Group] = {i: _Group() for i in range(num_groups)}
        self._embedded = None
        self._evict_client = None  # wire client of an external lighthouse
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
        self._base_env = base
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Launcher":
        for i in range(self._num_groups):
            self.spawn(i)
        return self

    def __enter__(self) -> "Launcher":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def spawn(self, group: int) -> None:
        """(Re)starts one replica group; clears any kill-hold on it."""
        g = self._groups[group]
        if g.proc is not None and g.proc.poll() is None:
            raise RuntimeError(f"group {group} is already running")
        g.held = False
        g.exited_clean = False
        g.backoff_until = 0.0  # an explicit spawn overrides a pending backoff
        g.killed_by_us = False
        g.evicted = False  # a new incarnation: its death is unreported
        env = dict(self._base_env)
        env["REPLICA_GROUP_ID"] = str(group)
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
        otherwise.  A failed evict only costs the survivors the heartbeat
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
        return restarted

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
        """SIGTERM every group, SIGKILL what is left after 10 s, close the
        logs and the embedded lighthouse."""
        for g in self._groups.values():
            if g.proc is not None and g.proc.poll() is None:
                g.proc.send_signal(signal.SIGTERM)
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
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("cmd", nargs=argparse.REMAINDER,
                        help="-- <command of one replica group>")
    args = parser.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        parser.error("missing replica-group command (after --)")

    launcher = Launcher(
        cmd, args.groups, lighthouse=args.lighthouse, max_restarts=args.max_restarts,
        min_replicas=args.min_replicas, join_timeout_ms=args.join_timeout_ms,
        log_dir=args.log_dir,
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
