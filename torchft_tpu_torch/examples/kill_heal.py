"""The supervised kill-and-heal drive: two replica groups of the train_ddp
example (or another example: ``train_hsdp``, a group of local ranks) under
:class:`~torchft_tpu_torch.launch.Launcher`, group 1 killed with SIGKILL
mid-run, restarted by the supervisor, healed live from group 0.  Where the
killed group's log names its local ranks' pids, the drive also checks that
none outlives the kill (an orphan rank would heartbeat for a dead group).

:func:`kill_and_heal` runs it, asserts what makes it a recovery (exactly
one restart, a heal after the kill, both groups ending at the same step
with the same ``params_sha256``, every loss finite) and returns what it
measured.  :func:`stop_and_resume` is the whole-job stop: the same two
groups with ``--ckpt_dir`` run to a step and stop, and a second job
resumes both from their disk checkpoints.  Times come from the host
clock: each log line is stamped when a poll every 20 ms reads it.

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from torchft_tpu_torch.launch import Launcher
from torchft_tpu_torch.metrics import METRICS_PATH_ENV, MetricsLogger

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_STEP = re.compile(r"\[group \d+\] step=(\d+) loss=(\S+) participants=(\d+) committed=(\w+)")
_FINAL = re.compile(r"FINAL step=(\d+) params_sha256=([0-9a-f]+)")
_RESUMED = re.compile(r"\[group \d+\] resumed from disk checkpoint step=(\d+)")
_RANK_PIDS = re.compile(r"\[group \d+\] local ranks pids=\[([0-9, ]*)\]")
LOG_POLL_S = 0.02
ORPHAN_GRACE_S = 5.0


def _alive(pid: int) -> bool:
    """Whether ``pid`` is a live process (a zombie is not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError, IndexError):
        return False


def _command(example: str, device: str, args: Sequence[str]) -> List[str]:
    return [sys.executable, "-m", f"torchft_tpu_torch.examples.{example}", "--device", device,
            *args]


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
    example: str = "train_ddp",
    args: Sequence[str] = (),
) -> dict:
    """Runs the drive; raises AssertionError or TimeoutError on a failed
    recovery.  ``merged_before_kill``: group 0's merged commits (2
    participants) before the kill; ``steps`` must exceed it.  ``example``
    names the module under ``torchft_tpu_torch.examples`` and ``args`` adds
    to its command line.  The result's ``metrics_path`` is the run's
    stream; ``killed_rank_pids`` lists the killed incarnation's local ranks
    (empty for a one-process group), each checked gone within
    ORPHAN_GRACE_S of the kill."""
    metrics_path = os.path.join(log_dir, "metrics.jsonl")
    env = {**(env or {}), METRICS_PATH_ENV: metrics_path}
    cmd = _command(example, device, ["--steps", str(steps), "--require-merged-final", "2",
                                     "--steps-cap", str(steps_cap), *args])
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
        killed_pids = [int(p) for _, line in tails[1].lines[:reborn]
                       for m in [_RANK_PIDS.search(line)] if m for p in m[1].split(",") if p]
        orphan_deadline = time.monotonic() + ORPHAN_GRACE_S
        while any(map(_alive, killed_pids)) and time.monotonic() < orphan_deadline:
            time.sleep(LOG_POLL_S)
        orphans = [p for p in killed_pids if _alive(p)]
        if orphans:
            raise AssertionError(f"local ranks {orphans} of the killed group outlived it")
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
        "killed_rank_pids": killed_pids,
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


def stop_and_resume(
    device: str,
    log_dir: str,
    *,
    steps: int = 10,
    ckpt_every: int = 5,
    timeout_s: float = 300.0,
    env: Optional[Dict[str, Optional[str]]] = None,
    example: str = "train_ddp",
    args: Sequence[str] = (),
) -> dict:
    """Runs the example's (train_ddp by default) two groups (the lighthouse forms no
    quorum of one, so neither trains alone) with ``--ckpt_dir`` to ``steps``, a multiple of
    ``ckpt_every``, so both stop right after a save; then a second job of
    the same groups to ``2 * steps``.  Asserts that each group of the second
    job printed "resumed from disk checkpoint step=<steps>" and that both
    end at one step with one ``params_sha256``; returns each job's seconds
    and the resumed step.  Raises AssertionError or TimeoutError."""
    if steps % ckpt_every:
        raise ValueError("steps must be a multiple of ckpt_every")
    ckpt_dir = os.path.join(log_dir, "ckpt")
    out: dict = {"ckpt_dir": ckpt_dir}
    for job, until in (("first", steps), ("resumed", 2 * steps)):
        job_dir = os.path.join(log_dir, job)
        cmd = _command(example, device, ["--steps", str(until), "--ckpt_dir", ckpt_dir,
                                         "--ckpt_every", str(ckpt_every), *args])
        tails = {g: _Tail(os.path.join(job_dir, f"g{g}.log")) for g in (0, 1)}
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        with Launcher(cmd, num_groups=2, lighthouse="embed", max_restarts=0, min_replicas=2,
                      log_dir=job_dir, env=env, cwd=_REPO) as launcher:
            while launcher.running():
                launcher.supervise_once()
                if time.monotonic() > deadline:
                    raise TimeoutError(f"stop_and_resume: the {job} job ran past {timeout_s} s")
                time.sleep(LOG_POLL_S)
            launcher.supervise_once()
            clean = launcher.all_exited_clean()
        for tail in tails.values():
            tail.close_writer()
        if not clean:
            raise AssertionError(f"a group of the {job} job exited with an error")
        finals = [tails[g].final() for g in (0, 1)]
        if None in finals or finals[0] != finals[1] or finals[0][0] != until:
            raise AssertionError(f"the {job} job's groups ended apart or short of step "
                                 f"{until}: {finals}")
        resumed = [[int(m[1]) for _, line in tails[g].lines for m in [_RESUMED.search(line)]
                    if m] for g in (0, 1)]
        want = [[steps], [steps]] if job == "resumed" else [[], []]
        if resumed != want:
            raise AssertionError(f"the {job} job's resume lines {resumed}, expected {want}")
        out[job] = {"seconds": time.monotonic() - t0, "final_step": finals[0][0],
                    "params_sha256": finals[0][1]}
    out["resumed_step"] = steps
    return out
