"""Goodput ledger: cause-attributed accounting of every committed step.

The port's own copy of ``torchft_tpu/obs/ledger.py``: the same record and
field names, registries, environment knobs and defaults, so either
package's consumers read either package's streams (held against the
JAX package's by tests/test_torch_obs.py).  Paths named below are the
JAX package's where the port has no counterpart.

tpu-ft's premise is per-step fault tolerance, so every second of lost wall
time has a *specific* cause — quorum wait, heal, wire stall, shaping,
drain.  Before this module those causes lived in four disconnected
artifacts (worker span JSONL, control-plane flight dumps, hop timelines,
lighthouse alerts) that only ``trace_export`` could join after the fact.
The ledger is the live join: each Manager classifies every committed
step's wall time into the pinned cause taxonomy below, rides the per-step
vector in ``step_summary`` records, and pushes cumulative per-cause
counters onto its lighthouse heartbeats (fields 14-16) so the cluster-wide
rollup (``GET /goodput.json``, ``tpuft_goodput_ratio``,
``tpuft_lost_seconds_total{cause=...}``) is always on and off the training
critical path — the Gemini-style accounting discipline (SOSP '23).

The taxonomy (:data:`CAUSES`) is a WIRE CONTRACT: the heartbeat's
``ledger_lost_seconds`` vector is ordered by :data:`LOST_CAUSES`, the
native lighthouse labels its counters from the same list
(``kLedgerCauses`` in native/src/lighthouse.cc), and docs/wire.md tables
it — tests/test_ledger.py greps all three against this module, the same
pinning discipline as ``metrics.EVENTS`` and ``FLIGHT_EVENTS``.

Classification rules (per committed step, wall = commit-to-commit
interval of this replica):

* ``quorum_server`` / ``quorum_transport`` — the ``quorum`` span, split by
  the server-side handling window when one is known (the flight
  join: live, the Manager reads its own ManagerServer's flight ring for
  the round's server span; post-hoc, obs/report.py joins the lighthouse
  dump by trace id).  With no split available the whole wait is charged
  ``quorum_server`` — formation dominates in practice, and a lump charge
  beats a fabricated split.
* ``wire`` / ``stall`` / ``combine`` / ``shaping`` — the step's
  allreduce-blocking span time (``allreduce_merge`` + ``allreduce_d2h`` +
  ``allreduce_h2d``: the only parts of the data plane that block the
  train thread) distributed proportionally to this step's hop-stall
  deltas from the ring engines (``link_attribution``'s classes:
  send-blocked net of shaping / recv-wait / decode+combine / pacer
  sleep).  The hop counters are CUMULATIVE per configure() and reset on
  every reconfiguration, so the delta window is epoch-banked exactly like
  obs/report.py's rollups (:func:`epoch_bank` is THE shared reset rule).
  A step with blocking time but no hop signal (non-ring collective,
  counters reset mid-window) charges it to ``other_ft``.
* ``heal`` — the ``heal`` + ``ec_reconstruct`` spans (reconstruction is
  healing by another path; same class so donor and donor-free clusters
  read comparably).
* ``drain`` — non-compute residual of a step run under a drain notice
  (the planned-departure cost visible from inside the step; the
  post-exit handoff gap is accounted cluster-side from stream coverage).
* ``other_ft`` — every remaining non-overlapped phase (commit vote,
  configure, ...).
* ``compute`` — wall minus everything above, floored at zero; when the
  charges exceed the wall (clock skew between span threads) they are
  scaled down proportionally, so the cause fractions always sum to ~1.0
  of the wall (pinned by tests/test_ledger.py).

Failed-commit steps are EXCLUDED from the ledger: their eventual commit
interval spans the retries, so the retried step's charges land in that
one committed interval (the same rule the straggler sentinel's step-time
telemetry uses).  Overlapped background phases (snapshot, ec_encode,
outer_sync) are tracked informationally (``overlap_s``) and never
charged — subtracting concurrent work from the wall would fabricate FT
cost the async pipeline specifically does not impose.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

from torchft_tpu_torch.obs.spans import OVERLAPPED_PHASES

__all__ = [
    "CAUSES",
    "LOST_CAUSES",
    "epoch_bank",
    "StepLedger",
    "ledger_rollup",
    "crosscheck_goodput",
]

# The pinned cause taxonomy.  Order matters: LOST_CAUSES (everything but
# compute) is the wire order of the heartbeat's ledger_lost_seconds vector
# (proto field 16) and of the native lighthouse's kLedgerCauses label
# array — append-only; never reorder.
CAUSES = (
    "compute",
    "wire",
    "stall",
    "combine",
    "shaping",
    "quorum_server",
    "quorum_transport",
    "heal",
    "drain",
    "other_ft",
    "resize",
)
LOST_CAUSES = CAUSES[1:]

# Span phases that block the train thread on the allreduce data plane —
# the wall time the hop-stall deltas distribute over.
_AR_BLOCK_PHASES = ("allreduce_merge", "allreduce_d2h", "allreduce_h2d")
# Phases with their own cause class (everything else non-overlapped falls
# into other_ft / drain).  "configure" is the membership-transition
# reconfigure (lane rendezvous + engine rebuild) — the ``resize`` cause,
# so seconds lost to elastic membership churn are named, never smeared
# into other_ft.
_CLASSIFIED_PHASES = ("quorum", "heal", "ec_reconstruct", "configure") + _AR_BLOCK_PHASES


def epoch_bank(slot: List[float], value: float) -> None:
    """One observation of a CUMULATIVE-per-configure counter into a
    ``[closed-epoch sum, current-epoch high-water mark]`` slot: a snapshot
    below the previous one means the counter reset (a reconfigure), so the
    old epoch's high-water mark is banked and a new epoch opens.  THE
    reset-detection rule, shared by every rollup over lane/hop counters —
    the live ledger here and obs/report.py's ``data_plane`` /
    ``link_attribution`` post-hoc rollups — so they cannot diverge."""
    if value < slot[1]:  # counter reset: a reconfigure happened
        slot[0] += slot[1]
    slot[1] = value


_HOP_KEYS = ("send_block_s", "recv_wait_s", "combine_s", "shape_s")


def _hop_totals(lanes: Optional[dict]) -> Optional[Dict[str, float]]:
    """Sums the per-tier hop aggregates of one lane_stats snapshot into one
    cumulative {send_block_s, recv_wait_s, combine_s, shape_s} reading, or
    None when the snapshot carries no hop telemetry."""
    if not isinstance(lanes, dict):
        return None
    hops = lanes.get("hops")
    if not isinstance(hops, dict) or not hops:
        return None
    out = {k: 0.0 for k in _HOP_KEYS}
    for tier in hops.values():
        if not isinstance(tier, dict):
            continue
        for k in _HOP_KEYS:
            out[k] += float(tier.get(k, 0) or 0)
    return out


class StepLedger:
    """Per-replica live goodput ledger.

    One instance per Manager.  ``observe_step`` once per commit vote with
    the step's wall interval, the span-phase accumulation
    (``SpanTracker.phases_ms()``, read before ``step_summary`` flushes
    it), and the lane_stats snapshot; returns the step's cause vector (or
    None for failed commits) and folds it into the cumulative per-cause
    counters the heartbeat carries.  Thread-safe: observe runs on the
    train thread, snapshots may be read from a scrape thread.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._compute_s = 0.0
        self._lost_s: Dict[str, float] = {c: 0.0 for c in LOST_CAUSES}
        self._overlap_s = 0.0
        self._steps = 0
        self._steps_failed = 0
        # cause-source hop counters, epoch-banked across reconfigures:
        # key -> [closed-epoch sum, current-epoch high-water mark].
        self._hop_acc: Dict[str, List[float]] = {
            k: [0.0, 0.0] for k in _HOP_KEYS
        }
        # False until the first snapshot opened the delta window (the
        # deltas themselves come from _hop_acc's banked sums, not a
        # stored previous snapshot).
        self._hop_seeded = False

    # -- observation --------------------------------------------------------

    def _hop_delta(self, lanes: Optional[dict]) -> Optional[Dict[str, float]]:
        """This step's hop-stall deltas from the cumulative snapshot, via
        the shared epoch-banking rule; None when no snapshot or this is the
        first observation (no delta window yet)."""
        cur = _hop_totals(lanes)
        if cur is None:
            return None
        prev_banked = {
            k: self._hop_acc[k][0] + self._hop_acc[k][1] for k in _HOP_KEYS
        }
        for k in _HOP_KEYS:
            epoch_bank(self._hop_acc[k], cur[k])
        if not self._hop_seeded:
            self._hop_seeded = True
            return None
        now_banked = {
            k: self._hop_acc[k][0] + self._hop_acc[k][1] for k in _HOP_KEYS
        }
        return {k: max(0.0, now_banked[k] - prev_banked[k]) for k in _HOP_KEYS}

    def observe_step(
        self,
        step: int,
        wall_s: float,
        phases_ms: Dict[str, float],
        lanes: Optional[dict] = None,
        committed: bool = True,
        draining: bool = False,
        quorum_server_ms: Optional[float] = None,
    ) -> Optional[Dict[str, float]]:
        """Classifies one step's wall interval; returns the cause vector
        (seconds, keys = :data:`CAUSES`) for committed steps, None for
        failed commits (excluded — see module docstring)."""
        with self._lock:
            overlap = (
                sum(float(phases_ms.get(k, 0.0)) for k in OVERLAPPED_PHASES)
                / 1e3
            )
            self._overlap_s += overlap
            # The hop window must advance even on failed commits, or the
            # retried step's stalls would be charged twice into the
            # eventual committed interval's delta.
            hop_d = self._hop_delta(lanes)
            if not committed:
                self._steps_failed += 1
                return None
            wall = max(0.0, float(wall_s))

            q = float(phases_ms.get("quorum", 0.0)) / 1e3
            if quorum_server_ms is not None:
                q_server = min(q, max(0.0, float(quorum_server_ms)) / 1e3)
                q_transport = q - q_server
            else:
                q_server, q_transport = q, 0.0
            heal = (
                float(phases_ms.get("heal", 0.0))
                + float(phases_ms.get("ec_reconstruct", 0.0))
            ) / 1e3
            ar_block = (
                sum(float(phases_ms.get(k, 0.0)) for k in _AR_BLOCK_PHASES)
                / 1e3
            )
            other = (
                sum(
                    float(v)
                    for k, v in phases_ms.items()
                    if k not in _CLASSIFIED_PHASES and k not in OVERLAPPED_PHASES
                )
                / 1e3
            )

            causes = {c: 0.0 for c in CAUSES}
            causes["quorum_server"] = q_server
            causes["quorum_transport"] = q_transport
            causes["heal"] = heal
            causes["resize"] = float(phases_ms.get("configure", 0.0)) / 1e3
            # Distribute the train-thread's allreduce-blocking time over the
            # wire classes proportionally to this step's hop-stall deltas.
            hop_sum = sum(hop_d.values()) if hop_d else 0.0
            if ar_block > 0.0 and hop_sum > 0.0:
                shaping = hop_d["shape_s"]
                wire = max(0.0, hop_d["send_block_s"] - shaping)
                stall = hop_d["recv_wait_s"]
                combine = hop_d["combine_s"]
                denom = wire + stall + combine + shaping
                if denom > 0.0:
                    causes["wire"] = ar_block * wire / denom
                    causes["stall"] = ar_block * stall / denom
                    causes["combine"] = ar_block * combine / denom
                    causes["shaping"] = ar_block * shaping / denom
                else:
                    other += ar_block
            else:
                other += ar_block
            if draining:
                causes["drain"] = other
            else:
                causes["other_ft"] = other

            lost = sum(causes.values())
            if lost > wall > 0.0:
                # Span threads and the commit clock can disagree by clock
                # granularity; scale the charges so fractions sum to 1.0.
                scale = wall / lost
                for c in LOST_CAUSES:
                    causes[c] *= scale
                lost = wall
            causes["compute"] = max(0.0, wall - lost)

            self._compute_s += causes["compute"]
            for c in LOST_CAUSES:
                self._lost_s[c] += causes[c]
            self._steps += 1
            return causes

    # -- reads --------------------------------------------------------------

    def goodput_ratio(self) -> Optional[float]:
        """Cumulative productive fraction: compute over accounted wall;
        None before the first observation."""
        with self._lock:
            total = self._compute_s + sum(self._lost_s.values())
            if total <= 0.0:
                return None
            return self._compute_s / total

    def snapshot(self) -> dict:
        """Cumulative totals: {goodput_ratio, compute_s, lost_s{cause},
        overlap_s, steps, steps_failed}."""
        with self._lock:
            total = self._compute_s + sum(self._lost_s.values())
            return {
                "goodput_ratio": (
                    round(self._compute_s / total, 4) if total > 0 else None
                ),
                "compute_s": round(self._compute_s, 4),
                "lost_s": {c: round(v, 4) for c, v in self._lost_s.items()},
                "overlap_s": round(self._overlap_s, 4),
                "steps": self._steps,
                "steps_failed": self._steps_failed,
            }

    def heartbeat_vector(self) -> Tuple[float, float, List[float]]:
        """(goodput_ratio, compute_seconds, lost_seconds in LOST_CAUSES
        order) — exactly what ``ManagerServer.set_ledger`` pushes onto
        heartbeat fields 14-16.  Ratio is 0.0 before the first
        observation (proto3 zero = not reported)."""
        with self._lock:
            total = self._compute_s + sum(self._lost_s.values())
            ratio = self._compute_s / total if total > 0 else 0.0
            return (
                ratio,
                self._compute_s,
                [self._lost_s[c] for c in LOST_CAUSES],
            )


# ---------------------------------------------------------------------------
# Stream rollups (post-hoc, over the metrics JSONL)
# ---------------------------------------------------------------------------


def ledger_rollup(events: Sequence[dict]) -> dict:
    """Sums the per-step ``ledger`` cause vectors riding in committed
    ``step_summary`` records: per-replica and cluster totals plus the
    cluster productive fraction over ACCOUNTED step time.  This is the
    stream-side mirror of the lighthouse's live rollup — the bench's
    goodput cross-check reads it, and an incident verdict charges lost
    seconds from it."""
    per_replica: Dict[str, Dict[str, float]] = {}
    n_steps = 0
    for ev in events:
        if ev.get("event") != "step_summary" or not ev.get("committed"):
            continue
        led = ev.get("ledger")
        if not isinstance(led, dict):
            continue
        causes = led.get("causes")
        if not isinstance(causes, dict):
            continue
        rid = str(ev.get("replica_id", ""))
        acc = per_replica.setdefault(rid, {c: 0.0 for c in CAUSES})
        for c in CAUSES:
            acc[c] += float(causes.get(c, 0.0) or 0.0)
        n_steps += 1
    totals = {c: 0.0 for c in CAUSES}
    for acc in per_replica.values():
        for c in CAUSES:
            totals[c] += acc[c]
    accounted = sum(totals.values())
    return {
        "per_replica": {
            rid: {c: round(v, 4) for c, v in acc.items()}
            for rid, acc in sorted(per_replica.items())
        },
        "totals": {c: round(v, 4) for c, v in totals.items()},
        "productive_fraction": (
            round(totals["compute"] / accounted, 4) if accounted > 0 else None
        ),
        "steps": n_steps,
    }


def crosscheck_goodput(events: Sequence[dict]) -> dict:
    """Cross-checks the commit-count dead-window headline against the
    ledger stream's own accounting of the same run.

    Two independent implementations over one JSONL stream must agree:
    the bench headline (``obs.report.deadwindow`` — commit timelines
    alone) and the ledger/report classification (stream-coverage gaps +
    heal credit + drain).  Both are expressed as lost seconds over the
    dead-window span; ``disagreement`` is the absolute difference of the
    two goodput fractions and the bench fails a trial above 0.05 — a
    larger gap means one of the accountings is lying about where the wall
    time went.  The per-step FT causes (``ledger`` rollup) are reported
    alongside as additive detail: the dead-window headline deliberately
    ignores steady-state FT overhead, so they are NOT in the
    disagreement.

    Returns {deadwindow_fraction, ledger_fraction, disagreement, ok,
    ledger} — fractions None (ok=True) when the run has no fault-charged
    headline to check."""
    from torchft_tpu_torch.obs import report

    commits = report.commit_timelines(events)
    faults = report.fault_times(events)
    dw = report.deadwindow(commits, faults)
    out = {
        "deadwindow_fraction": dw["fraction"],
        "ledger_fraction": None,
        "disagreement": None,
        "ok": True,
        "ledger": ledger_rollup(events),
    }
    if dw["fraction"] is None or not dw["span_s"]:
        return out
    attr = report.attribute(events)
    t = attr["totals"]
    gap_lost = t["idle_s"] + t["drain_s"] + t["heal_s"]
    lf = max(0.0, 1.0 - gap_lost / dw["span_s"])
    out["ledger_fraction"] = round(lf, 4)
    out["disagreement"] = round(abs(lf - dw["fraction"]), 4)
    out["ok"] = out["disagreement"] <= 0.05
    return out
