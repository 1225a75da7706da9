"""The supervised kill-and-heal drive: two replica groups of the train_ddp
example under :class:`~torchft_tpu_torch.launch.Launcher`, group 1 killed
with SIGKILL mid-run, restarted by the supervisor, healed live from group 0.

:func:`kill_and_heal` runs it, asserts what makes it a recovery (exactly
one restart, a heal after the kill, both groups ending at the same step
with the same ``params_sha256``, every loss finite) and returns what it
measured.  Times come from the host clock: each log line is stamped when a
poll every 20 ms reads it.

Both groups write one metrics stream, ``metrics.jsonl`` in the log
directory (``TPUFT_METRICS_PATH``), and the drive writes a ``fault`` record
(kind ``kill``, the victim group, the wall time) into it as it sends the
SIGKILL, as the JAX package's benchmark does, so
:func:`torchft_tpu_torch.obs.report.deadwindow` charges the same fault.
"""

from __future__ import annotations

import math
import os
import re
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from torchft_tpu_torch.launch import Launcher
from torchft_tpu_torch.metrics import METRICS_PATH_ENV, MetricsLogger

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_STEP = re.compile(r"\[group \d+\] step=(\d+) loss=(\S+) participants=(\d+) committed=(\w+)")
_FINAL = re.compile(r"FINAL step=(\d+) params_sha256=([0-9a-f]+)")
LOG_POLL_S = 0.02


class _Tail:
    """The lines of a growing log file, each with the host time it was read."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._pos = 0
        self._partial = b""
        self.lines: List[Tuple[float, str]] = []

    def poll(self) -> None:
        try:
            with open(self._path, "rb") as f:
                f.seek(self._pos)
                data = f.read()
        except FileNotFoundError:
            return
        self._pos += len(data)
        now = time.monotonic()
        *done, self._partial = (self._partial + data).split(b"\n")
        self.lines += [(now, line.decode(errors="replace")) for line in done]

    def close_writer(self) -> int:
        """Reads all the file holds once its writer is dead; a line the kill
        cut short stays a line of its own.  Returns the number of lines: the
        next writer's lines start at that index."""
        self.poll()
        if self._partial:
            self.lines.append((time.monotonic(), self._partial.decode(errors="replace")))
            self._partial = b""
        return len(self.lines)

    def count(self, text: str, first: int = 0) -> int:
        return sum(text in line for _, line in self.lines[first:])

    def steps(self, after: float = -math.inf, before: float = math.inf,
              first: int = 0) -> List[tuple]:
        """(time, step, loss, participants, committed) of each step line,
        from line ``first`` on."""
        out = []
        for t, line in self.lines[first:]:
            m = _STEP.search(line)
            if m and after < t < before:
                out.append((t, int(m[1]), float(m[2]), int(m[3]), m[4] == "True"))
        return out

    def final(self) -> Optional[Tuple[int, str]]:
        for _, line in self.lines:
            m = _FINAL.search(line)
            if m:
                return int(m[1]), m[2]
        return None


def _mean_step_ms(steps: List[tuple]) -> Optional[float]:
    """Mean spacing of consecutive step lines, in ms (None under two)."""
    if len(steps) < 2:
        return None
    return 1e3 * (steps[-1][0] - steps[0][0]) / (len(steps) - 1)


def kill_and_heal(
    device: str,
    log_dir: str,
    *,
    steps: int = 60,
    steps_cap: int = 100000,
    merged_before_kill: int = 3,
    timeout_s: float = 300.0,
    env: Optional[Dict[str, Optional[str]]] = None,
) -> dict:
    """Runs the drive; raises AssertionError or TimeoutError on a failed
    recovery.  ``merged_before_kill``: group 0's merged commits (2
    participants) before the kill; ``steps`` must exceed it.  The result's
    ``metrics_path`` is the run's stream."""
    metrics_path = os.path.join(log_dir, "metrics.jsonl")
    env = {**(env or {}), METRICS_PATH_ENV: metrics_path}
    cmd = [sys.executable, "-m", "torchft_tpu_torch.examples.train_ddp", "--device", device,
           "--steps", str(steps), "--require-merged-final", "2", "--steps-cap", str(steps_cap)]
    tails = {g: _Tail(os.path.join(log_dir, f"g{g}.log")) for g in (0, 1)}
    deadline = time.monotonic() + timeout_s
    with Launcher(cmd, num_groups=2, lighthouse="embed", max_restarts=3, log_dir=log_dir,
                  env=env, cwd=_REPO) as launcher:

        def wait(what: str, done: Callable[[], bool]) -> None:
            while True:
                launcher.supervise_once()
                for tail in tails.values():
                    tail.poll()
                if done():
                    return
                if time.monotonic() > deadline:
                    raise TimeoutError(f"kill_and_heal: {what} not reached in {timeout_s} s")
                time.sleep(LOG_POLL_S)

        def merged(g: int) -> int:
            return sum(p == 2 and c for *_, p, c in tails[g].steps())

        wait("merged steps before the kill", lambda: merged(0) >= merged_before_kill
             and merged(1) >= 3)
        faults = MetricsLogger(metrics_path, replica_id="kill_heal")
        faults.emit("fault", ts=time.time(), kind="kill", group="1", plan="kill")
        faults.close()
        t_kill = time.monotonic()
        launcher.kill(1, hold=False)
        # kill() returns once the process is dead, so the log holds all of
        # the killed incarnation's lines, some perhaps not read yet; the
        # restarted one's begin after them.  Telling them apart by read time
        # would take a merged step the killed process logged just before the
        # kill for the restarted group's first.
        reborn = tails[1].close_writer()
        wait("the restart", lambda: launcher.restarts(1) >= 1)
        t_restart = time.monotonic()
        wait("a heal of the restarted group",
             lambda: tails[1].count("healing from replica", first=reborn) > 0)
        wait("both FINAL lines", lambda: all(t.final() for t in tails.values()))
        restarts = [launcher.restarts(0), launcher.restarts(1)]

    (step0, sha0), (step1, sha1) = tails[0].final(), tails[1].final()
    losses = [s[2] for tail in tails.values() for s in tail.steps()]
    if restarts != [0, 1]:
        raise AssertionError(f"expected group 1 restarted once and group 0 never: {restarts}")
    if step0 != step1 or sha0 != sha1:
        raise AssertionError(f"groups ended apart: g0 step {step0} {sha0}, g1 step {step1} {sha1}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError("a printed loss is not finite")
    heal_t = next(t for t, line in tails[1].lines[reborn:] if "healing from replica" in line)
    first_merged = next((s for s in tails[1].steps(first=reborn) if s[3] == 2 and s[4]), None)
    if first_merged is None:
        raise AssertionError("the restarted group never logged a merged commit")
    after_kill = tails[0].steps(after=t_kill)
    return {
        "metrics_path": metrics_path,
        "final_step": step0,
        "params_sha256": sha0,
        "restarts": restarts,
        "steps_logged": len(losses),
        "kill_to_restart_s": t_restart - t_kill,
        "kill_to_heal_line_s": heal_t - t_kill,
        "recovery_s": first_merged[0] - t_kill,
        "survivor_uncommitted_steps": sum(not c for *_, c in after_kill),
        "survivor_solo_step_ms": _mean_step_ms(
            [s for s in after_kill if s[3] == 1 and s[4] and s[0] < first_merged[0]]),
        "survivor_merged_step_ms": _mean_step_ms(
            [s for s in tails[0].steps(before=t_kill) if s[3] == 2 and s[4]]),
    }
