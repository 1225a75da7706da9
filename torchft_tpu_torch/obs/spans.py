"""Step-scoped tracing: begin/end spans for Manager step phases.

The port's own copy of ``torchft_tpu/obs/spans.py``: the same record and
field names, registries, environment knobs and defaults, so either
package's consumers read either package's streams (held against the
JAX package's by tests/test_torch_obs.py).  Paths named below are the
JAX package's where the port has no counterpart.

Turns the flat metrics event stream into a distributed trace without a
tracing dependency: each phase of a step runs inside ``SpanTracker.span``,
which measures a monotonic-clock duration and emits one ``span`` record
keyed by ``(slice_gen, step, replica_id)`` — ``replica_id`` comes from the
underlying :class:`~torchft_tpu_torch.metrics.MetricsLogger`, ``slice_gen`` from
``TPUFT_SLICE_GEN`` (the scheduler's restart counter, see spec.py), so
records from every incarnation of every replica across restarts merge into
one unambiguous timeline.  ``obs/report.py`` is the matching consumer.

The known phase names are fixed in :data:`PHASES`; a span may use any name
(the record is self-describing) but report.py's attribution buckets are
built from these.

One tracker per Manager.  Phases of the same step may run on different
threads (the quorum thread vs the train loop), so the per-step breakdown
is lock-guarded; ``step_summary(step, committed=...)`` flushes the
accumulated phases as one record after the commit vote.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Dict, Optional

from torchft_tpu_torch.metrics import MetricsLogger

__all__ = [
    "PHASES",
    "OVERLAPPED_PHASES",
    "Span",
    "SpanTracker",
    "StepTimeStats",
]

# The Manager step phases report.py attributes (docs/architecture.md
# "Observability").  quorum = blocking wait on the lighthouse round;
# configure = collective rebuild on quorum change; heal = peer weight
# fetch; allreduce_d2h = the GradientAverager's per-bucket device->host
# fetch into the persistent flat buffers (blocks the train thread, so it
# is FT-overhead time, NOT productive compute — report.py charges it to
# the other-FT bucket and the straggler sentinel subtracts it from busy
# time); allreduce_h2d = the matching result scatter-back (device_put of
# reduced buckets onto the leaves' devices/shardings — with device wire
# prep it moves wire-dtype bytes; charged exactly like allreduce_d2h so
# the FULL round-trip cost is attributed, not just the fetch);
# allreduce_merge = drain of pending allreduce futures at commit
# time; commit_vote = the two-phase commit barrier RPC; snapshot = the
# donor-side device->host flatten on the HTTP transport's background
# snapshotter — an OVERLAPPED phase (it runs concurrently with the train
# step, so report.py shows it but does not charge it against productive
# time; a snapshot span on the critical path is exactly the regression the
# async pipeline exists to prevent); outer_sync = one fragment's
# background pseudogradient round on the semisync engine's worker
# (torchft_tpu/semisync) — OVERLAPPED for the same reason: it runs
# concurrent with inner steps, and only the round-end drain (charged as
# allreduce_merge) ever blocks the train thread; ec_encode = the k+m
# Reed-Solomon shard encode on the same background snapshotter
# (torchft_tpu/ec) — OVERLAPPED like snapshot, and the bench's
# donor-side-overhead cell exists to keep it that way; ec_reconstruct =
# the donor-free heal fallback assembling max-step state from surviving
# shard holders — blocks the healing group's quorum thread exactly like
# heal, and report.py folds it into the heal class.
PHASES = (
    "quorum",
    "configure",
    "heal",
    "ec_reconstruct",
    "allreduce_d2h",
    "allreduce_h2d",
    "allreduce_merge",
    "commit_vote",
    "snapshot",
    "ec_encode",
    "outer_sync",
)

# Phases that run on background threads concurrent with compute: report.py
# excludes these from per-step critical-path attribution.
OVERLAPPED_PHASES = ("snapshot", "ec_encode", "outer_sync")


class Span:
    """One in-flight phase measurement; ``duration_ms`` is valid after the
    ``with`` block exits (monotonic clock, NTP-immune)."""

    def __init__(self, tracker: "SpanTracker", phase: str, step: int, fields: dict):
        self._tracker = tracker
        self.phase = phase
        self.step = step
        self.fields = fields
        self.t_start = 0.0
        self.duration_ms: float = 0.0

    def __enter__(self) -> "Span":
        self.t_start = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.duration_ms = round((time.monotonic() - self.t_start) * 1e3, 3)
        self._tracker._finish(self, ok=exc_type is None)


class SpanTracker:
    """Emits ``span`` / ``step_summary`` records through a MetricsLogger.

    Spans are emitted even for phases that raise (with ``ok: false``) so a
    hung-then-failed quorum still shows up in the trace with its real
    duration.
    """

    def __init__(
        self, metrics: MetricsLogger, slice_gen: Optional[int] = None
    ) -> None:
        self._metrics = metrics
        if slice_gen is None:
            try:
                slice_gen = int(os.environ.get("TPUFT_SLICE_GEN", "0"))
            except ValueError:
                slice_gen = 0
        self.slice_gen = slice_gen
        self._lock = threading.Lock()
        # phase -> accumulated ms since the last step_summary.  Keyed by
        # phase, NOT by step: a heal fast-forwards the step number mid-step
        # (quorum ran at the old step, heal at max_step, the vote at
        # max_step), yet all of it is one train-loop iteration — the
        # summary flushes everything since the previous vote.  Individual
        # span records still carry their own step.
        self._acc: Dict[str, float] = {}

    @property
    def enabled(self) -> bool:
        return self._metrics.enabled

    def span(self, phase: str, step: int, **fields) -> Span:
        """Context manager measuring one phase of one step."""
        return Span(self, phase, step, fields)

    def record(self, phase: str, step: int, duration_ms: float, **fields) -> None:
        """Emits a span measured elsewhere (the port's train-thread wait
        for the quorum thread's synchronous donor snapshot, which only
        the quorum thread's clock marks bound); the port's addition."""
        span = Span(self, phase, step, fields)
        span.duration_ms = round(duration_ms, 3)
        self._finish(span, ok=True)

    def phases_ms(self) -> Dict[str, float]:
        """Copy of the per-phase accumulation since the last
        ``step_summary`` flush — the goodput ledger reads this at commit
        time (BEFORE the flush) to classify the step's wall interval into
        its cause taxonomy (torchft_tpu/obs/ledger.py)."""
        with self._lock:
            return dict(self._acc)

    def ft_accounted_ms(self) -> float:
        """Milliseconds accumulated in NON-overlapped phases since the last
        ``step_summary`` flush — the FT wait time of the step in flight.
        The Manager subtracts this from the commit-to-commit wall interval
        to get the step's BUSY time for the straggler sentinel: in lockstep
        training the raw commit interval equalizes across the quorum (the
        slow host delays everyone), so only wall-minus-waits distinguishes
        the replica that actually computed the whole time."""
        with self._lock:
            return sum(
                v for k, v in self._acc.items() if k not in OVERLAPPED_PHASES
            )

    def _finish(self, span: Span, ok: bool) -> None:
        with self._lock:
            self._acc[span.phase] = self._acc.get(span.phase, 0.0) + span.duration_ms
        rec = {
            "phase": span.phase,
            "step": span.step,
            "slice_gen": self.slice_gen,
            "duration_ms": span.duration_ms,
        }
        if not ok:
            rec["ok"] = False
        rec.update(span.fields)
        self._metrics.emit("span", **rec)

    def step_summary(self, step: int, committed: bool, **fields) -> None:
        """Emits the per-step phase breakdown and resets the accumulator.
        Call once per step, after the commit vote."""
        with self._lock:
            rec = {
                "step": step,
                "slice_gen": self.slice_gen,
                "committed": committed,
                "phases": {k: round(v, 3) for k, v in self._acc.items()},
                "accounted_ms": round(sum(self._acc.values()), 3),
            }
            self._acc = {}
        rec.update(fields)
        self._metrics.emit("step_summary", **rec)


class StepTimeStats:
    """Rolling per-step wall-time statistics for the straggler sentinel.

    ``observe(ms)`` once per committed step with the step's BUSY
    milliseconds (commit-to-commit wall minus the FT wait phases; see
    ``SpanTracker.ft_accounted_ms``).  Maintains an EWMA — the smoothed
    pace the Manager pushes onto its lighthouse heartbeats — plus a sliding
    window for p50/p99, which ride in the ``step_summary`` record and
    bench.py's step-time distributions.

    Knobs: ``TPUFT_STEP_TIME_ALPHA`` (EWMA weight of the newest step,
    default 0.5 — heavy enough that a host going 2x slow crosses a 1.5x
    alert threshold on its first slow step, so detection latency is the
    sentinel's grace count, not the smoothing) and
    ``TPUFT_STEP_TIME_WINDOW`` (percentile window, default 64 steps).
    Thread-safe: observe runs on the train thread, snapshots may be read
    from anywhere.
    """

    def __init__(
        self, alpha: Optional[float] = None, window: Optional[int] = None
    ) -> None:
        if alpha is None:
            try:
                alpha = float(os.environ.get("TPUFT_STEP_TIME_ALPHA", "0.5"))
            except ValueError:
                alpha = 0.5
        if not (0.0 < alpha <= 1.0):
            alpha = 0.5
        if window is None:
            try:
                window = int(os.environ.get("TPUFT_STEP_TIME_WINDOW", "64"))
            except ValueError:
                window = 64
        self.alpha = alpha
        self._lock = threading.Lock()
        self._window: deque = deque(maxlen=max(2, window))
        self._ewma: Optional[float] = None
        self._last: float = 0.0
        self._n = 0

    def observe(self, ms: float) -> None:
        if ms < 0.0:
            return
        with self._lock:
            self._last = ms
            self._ewma = (
                ms
                if self._ewma is None
                else self.alpha * ms + (1.0 - self.alpha) * self._ewma
            )
            self._window.append(ms)
            self._n += 1

    @property
    def ewma_ms(self) -> float:
        with self._lock:
            return self._ewma or 0.0

    @property
    def last_ms(self) -> float:
        with self._lock:
            return self._last

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the sliding window (0 when empty)."""
        with self._lock:
            if not self._window:
                return 0.0
            ordered = sorted(self._window)
            idx = min(len(ordered) - 1, int(p / 100.0 * len(ordered)))
            return ordered[idx]

    def snapshot(self) -> Dict[str, float]:
        """{ewma, last, p50, p99, max, n} in ms — the step_summary payload."""
        with self._lock:
            ordered = sorted(self._window)
            n = len(ordered)

            def pct(p: float) -> float:
                return ordered[min(n - 1, int(p / 100.0 * n))] if n else 0.0

            return {
                "ewma": round(self._ewma or 0.0, 3),
                "last": round(self._last, 3),
                "p50": round(pct(50.0), 3),
                "p99": round(pct(99.0), 3),
                "max": round(ordered[-1], 3) if n else 0.0,
                "n": self._n,
            }
