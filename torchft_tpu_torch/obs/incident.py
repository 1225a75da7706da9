"""Incident auto-capture: bundle the evidence, emit a verdict.

The native lighthouse RECORDS incident triggers (``GET /incident.json``;
an alert raise, an unannounced heartbeat loss, a windowed-goodput dip
below the EWMA floor — see native/src/lighthouse.cc) but writes nothing to
disk itself.  This module does the capture: it polls the feed, and
when a new trigger appears it snapshots the lighthouse's live state
(flight ring, alerts, goodput ledger, status), tails the run's span
JSONL, and — after the run, when the shutdown dumps exist — folds in the
manager flight rings and hop timelines, all into one
``incident_<step>/`` directory with a machine-readable **verdict**:
which replica/edge, which cause class, how many seconds charged.

The counterpart of ``torchft_tpu/obs/incident.py``: the same bundle
layout, manifest and verdict, read from the port's own streams and dumps
(the Manager's ``hops_<replica>.json`` under ``TPUFT_HOP_DUMP_DIR``, the
native servers' ``flight_*.json`` under ``TPUFT_FLIGHT_DIR``).  The
launcher's watcher (:mod:`torchft_tpu_torch.obs.watcher`) drives it live.

Bundle layout (``incident.json`` is the manifest)::

    incident_<step>/
      incident.json            manifest: trigger record, file inventory,
                               verdict
      lighthouse_flight.json   /debug/flight.json at capture time
      alerts.json              /alerts.json
      goodput.json             /goodput.json
      status.json              /status.json
      spans_tail.jsonl         last N lines of each metrics JSONL
      flight_manager_*.json    manager shutdown dumps (finalize pass)
      hops_*.json              hop-timeline dumps (finalize pass)
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import urllib.request
from typing import Dict, List, Optional, Sequence

from torchft_tpu_torch.obs.ledger import LOST_CAUSES

__all__ = [
    "IncidentWatcher",
    "fetch_json",
    "capture_bundle",
    "finalize_bundle",
    "load_bundle",
    "verdict",
]

# How many trailing stream lines the live capture keeps per JSONL input.
_SPAN_TAIL_LINES = 2000


def _http_base(address: str) -> str:
    address = address.strip()
    if not address.startswith("http://") and not address.startswith("https://"):
        address = "http://" + address
    return address.rstrip("/")


def fetch_json(address: str, path: str, timeout: float = 5.0) -> Optional[dict]:
    """GET ``<address><path>`` and parse JSON; None on any failure — the
    capture must degrade, never crash the run it is observing."""
    try:
        with urllib.request.urlopen(
            _http_base(address) + path, timeout=timeout
        ) as resp:
            out = json.loads(resp.read().decode())
        return out if isinstance(out, dict) else None
    except Exception:  # noqa: BLE001
        return None


class IncidentWatcher:
    """Polls a lighthouse's ``GET /incident.json`` for NEW trigger
    records (monotone ids; already-seen ids are skipped)."""

    def __init__(self, http_address: str) -> None:
        self.http_address = http_address
        self._seen: set = set()

    def poll(self) -> List[dict]:
        feed = fetch_json(self.http_address, "/incident.json")
        if not feed:
            return []
        fresh = []
        for rec in feed.get("incidents", []):
            if not isinstance(rec, dict):
                continue
            rid = rec.get("id")
            if rid in self._seen:
                continue
            self._seen.add(rid)
            fresh.append(rec)
        return fresh

    def unsee(self, incident_id) -> None:
        """Re-queues a trigger whose CAPTURE failed (transient I/O): the
        next poll returns it again instead of silently dropping the
        incident the feed already recorded."""
        self._seen.discard(incident_id)


def capture_bundle(
    workdir: str,
    http_address: str,
    incident: dict,
    metrics_paths: Sequence[str] = (),
) -> str:
    """LIVE capture: snapshot the lighthouse's state while it is still
    serving, plus span tails of the given metrics streams.  Returns the
    bundle directory (``incident_<step>`` under ``workdir``; a second
    trigger for the same step reuses the directory — first evidence
    wins, later triggers only append to the manifest's trigger list)."""
    step = int(incident.get("step", 0))
    bundle = os.path.join(workdir, f"incident_{step}")
    os.makedirs(bundle, exist_ok=True)
    manifest_path = os.path.join(bundle, "incident.json")
    manifest: dict = {"schema": 1, "incidents": [], "artifacts": {}}
    repeat = False
    if os.path.exists(manifest_path):
        try:
            with open(manifest_path, "r", encoding="utf-8") as f:
                prev = json.load(f)
            if isinstance(prev, dict):
                manifest = prev
                manifest.setdefault("incidents", [])
                manifest.setdefault("artifacts", {})
                repeat = True
        except (OSError, ValueError):
            pass
    if not repeat:
        # First evidence wins: a repeat trigger for the same step (one
        # SIGKILL fires both kill signatures) only appends to the
        # manifest's trigger list below — re-fetching here would let the
        # bounded flight ring wrap past the death-adjacent events the
        # first capture preserved.
        artifacts: Dict[str, str] = {}
        for path, fname in (
            ("/debug/flight.json", "lighthouse_flight.json"),
            ("/alerts.json", "alerts.json"),
            ("/goodput.json", "goodput.json"),
            ("/status.json", "status.json"),
        ):
            doc = fetch_json(http_address, path)
            if doc is None:
                continue
            out = os.path.join(bundle, fname)
            with open(out, "w", encoding="utf-8") as f:
                json.dump(doc, f)
            artifacts[fname] = path
        tail_path = os.path.join(bundle, "spans_tail.jsonl")
        with open(tail_path, "wb") as out_f:
            for mp in metrics_paths:
                try:
                    # deque streams the file with O(tail) memory — the
                    # capture runs inside a live (degraded) cluster, and a
                    # long run's JSONL can be GBs.
                    from collections import deque

                    with open(mp, "rb") as f:
                        lines = deque(f, maxlen=_SPAN_TAIL_LINES)
                    out_f.writelines(lines)
                except OSError:
                    continue
        artifacts["spans_tail.jsonl"] = "tail"
        manifest["artifacts"].update(artifacts)
    manifest["incidents"].append(incident)
    with open(manifest_path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
    _prune_bundles(workdir, keep=bundle)
    return bundle


def _prune_bundles(workdir: str, keep: Optional[str] = None) -> List[str]:
    """Bounds incident-bundle disk growth: keeps the TPUFT_INCIDENT_RETAIN
    newest ``incident_<step>/`` dirs (default 16; 0 or negative disables
    pruning) and removes the rest, oldest step first.  ``keep`` is never
    pruned — the bundle being written must survive its own capture even
    at retain=1 with many older dirs present.  Returns the pruned paths."""
    try:
        retain = int(os.environ.get("TPUFT_INCIDENT_RETAIN", "16"))
    except ValueError:
        retain = 16
    if retain <= 0:
        return []
    bundles = []
    for p in glob.glob(os.path.join(workdir, "incident_*")):
        if not os.path.isdir(p):
            continue
        tail = os.path.basename(p)[len("incident_"):]
        try:
            step = int(tail)
        except ValueError:
            continue  # not a capture dir of ours — never delete it
        bundles.append((step, p))
    bundles.sort()
    keep_abs = os.path.abspath(keep) if keep else None
    pruned = []
    excess = len(bundles) - retain
    for step, p in bundles:
        if excess <= 0:
            break
        if keep_abs and os.path.abspath(p) == keep_abs:
            continue
        shutil.rmtree(p, ignore_errors=True)
        pruned.append(p)
        excess -= 1
    return pruned


def finalize_bundle(
    bundle: str,
    workdir: str,
    events: Optional[Sequence[dict]] = None,
) -> dict:
    """POST-RUN pass: collect the shutdown artifacts (manager flight
    dumps, hop timelines) the live capture could not see, compute the
    verdict, and rewrite the manifest.  Returns the final manifest."""
    for pattern in ("flight_manager_*.json", "hops_*.json"):
        for src in glob.glob(os.path.join(workdir, pattern)):
            dst = os.path.join(bundle, os.path.basename(src))
            if os.path.abspath(src) != os.path.abspath(dst):
                try:
                    shutil.copyfile(src, dst)
                except OSError:
                    continue
    manifest_path = os.path.join(bundle, "incident.json")
    try:
        with open(manifest_path, "r", encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        manifest = {"schema": 1, "incidents": [], "artifacts": {}}
    for pattern in ("flight_manager_*.json", "hops_*.json"):
        for p in glob.glob(os.path.join(bundle, pattern)):
            manifest.setdefault("artifacts", {})[os.path.basename(p)] = "dump"
    manifest["verdict"] = verdict(bundle, events=events)
    with open(manifest_path, "w", encoding="utf-8") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_bundle(bundle: str) -> dict:
    """Reads a bundle back: the manifest plus the parsed artifacts it
    names (missing/corrupt artifacts are simply absent).  Raises on a
    missing or unparseable manifest — a bundle without its manifest is
    not a bundle."""
    with open(os.path.join(bundle, "incident.json"), "r", encoding="utf-8") as f:
        manifest = json.load(f)
    if not isinstance(manifest, dict) or "incidents" not in manifest:
        raise ValueError(f"{bundle}: not an incident bundle manifest")
    out = {"manifest": manifest}
    for fname in ("lighthouse_flight.json", "alerts.json", "goodput.json",
                  "status.json"):
        path = os.path.join(bundle, fname)
        try:
            with open(path, "r", encoding="utf-8") as f:
                out[fname] = json.load(f)
        except (OSError, ValueError):
            continue
    tail = os.path.join(bundle, "spans_tail.jsonl")
    if os.path.exists(tail):
        from torchft_tpu_torch.obs.report import read_events

        out["events"] = read_events([tail])
    return out


# ---------------------------------------------------------------------------
# Verdict
# ---------------------------------------------------------------------------

_GROUP = lambda rid: str(rid).split(":", 1)[0]  # noqa: E731


def _ledger_lost(goodput: Optional[dict]) -> Dict[str, float]:
    if not goodput:
        return {c: 0.0 for c in LOST_CAUSES}
    lost = goodput.get("lost_seconds") or {}
    return {c: float(lost.get(c, 0.0) or 0.0) for c in LOST_CAUSES}


def verdict(bundle: str, events: Optional[Sequence[dict]] = None) -> dict:
    """Machine-readable incident verdict from a bundle's artifacts.

    Returns ``{kind, replica, edge?, cause, lost_s, charged_fraction?,
    incident}``: the replica/edge the evidence names, the ledger cause
    class the lost time belongs to, and how many seconds were charged.
    ``charged_fraction`` (matching-cause charge over total measured lost
    time) is filled when a full event stream is available — the bench
    cells assert it >= 0.9 against the injected fault.

    Mapping:

    * ``replica_stale`` — a SIGKILL/crash: the victim is the stale id's
      group; the charge is the dead-window time (from the event stream
      when present, else the cluster ledger's heal + quorum classes).
    * ``alert:straggler`` — the victim is the alert's replica; cause is
      compute drag (the ledger sees it as everyone else's ``stall`` /
      equalized wall, so the alert's relative-slowness ratio carries the
      magnitude).
    * ``alert:slow_link`` — the edge is (src -> dst) from the alert
      (sender reports, receiver is the drain target); cause ``stall`` /
      ``wire``.
    * ``alert:ec_coverage`` — cluster-scope redundancy loss (no wall time
      charged; the verdict names the shortfall).
    * ``goodput_floor`` — windowed dip: names the lighthouse-attributed
      culprit (``culprit_replica`` / ``culprit_region`` /
      ``dominant_cause`` / ``charged_seconds`` / ``delta_by_replica``
      from the trigger record) when the window scored one, else falls
      back to the cumulative ledger's largest lost-share cause.
    * ``alert:slo_burn`` — the SLO engine's multi-window burn alert:
      carries both burn rates plus the same culprit attribution.
    * ``region_stale`` — a federated region's digest stream went dark (a
      correlated preemption wave / region loss): the verdict names the
      dead REGION (``region`` field) rather than a single group; the
      charge is the survivors' dead window while the global quorum
      reforms.
    """
    data = load_bundle(bundle)
    manifest = data["manifest"]
    incidents = manifest.get("incidents", [])
    incident = incidents[0] if incidents else {}
    reason = str(incident.get("reason", ""))
    goodput = data.get("goodput.json")
    alerts = (data.get("alerts.json") or {}).get("alerts", [])
    if events is None:
        events = data.get("events") or []

    out: dict = {
        "kind": "unknown",
        "replica": None,
        "cause": None,
        "lost_s": None,
        "charged_fraction": None,
        "incident": incident,
    }
    lost = _ledger_lost(goodput)

    def match_alert(kind: str) -> Optional[dict]:
        for a in reversed(alerts):
            if a.get("kind") == kind:
                return a
        return None

    if reason in ("replica_stale", "replica_evicted"):
        # Both kill signatures: an unannounced heartbeat loss, or the
        # supervisor reporting the death first (launcher kills evict
        # before the heartbeat ever goes stale).
        out["kind"] = "kill"
        out["replica"] = _GROUP(incident.get("replica_id", ""))
        out["cause"] = "dead_window"
        if events:
            from torchft_tpu_torch.obs import report

            commits = report.commit_timelines(events)
            faults = report.fault_times(events)
            dw = report.deadwindow(commits, faults)
            if dw["dead_time_s"] is not None:
                out["lost_s"] = round(dw["dead_time_s"], 3)
                # Matching-cause charge: of the lost wall attributable to
                # THIS incident — the dead window plus the survivors'
                # EXCESS per-step ledger lost inside the kill-containing
                # gaps (quorum stalls while the quorum reforms, heal
                # serving) — the dead window itself must dominate.  The
                # excess is each step's lost MINUS that replica's baseline
                # (median per-step lost outside the windows): survivors
                # keep paying their steady-state FT overhead during the
                # window at their normal pace, and that overhead is not
                # lost to this incident.
                windows = []
                for g in {grp for _, grp in faults}:
                    g_kills = sorted(ts for ts, grp in faults if grp == g)
                    cs = sorted(commits.get(g, []))
                    for a, b in zip(cs, cs[1:]):
                        if any(a <= k < b for k in g_kills):
                            windows.append((a, b))

                def step_lost(ev: dict) -> Optional[float]:
                    if ev.get("event") != "step_summary" or not ev.get(
                        "committed"
                    ):
                        return None
                    led = ev.get("ledger")
                    if not isinstance(led, dict):
                        return None
                    causes = led.get("causes") or {}
                    return sum(
                        float(v or 0.0)
                        for c, v in causes.items()
                        if c != "compute"
                    )

                in_window: Dict[str, List[float]] = {}
                baseline: Dict[str, List[float]] = {}
                for ev in events:
                    ev_lost = step_lost(ev)
                    if ev_lost is None:
                        continue
                    rid = str(ev.get("replica_id", ""))
                    ts = float(ev.get("ts", 0.0))
                    if any(a <= ts <= b for a, b in windows):
                        in_window.setdefault(rid, []).append(ev_lost)
                    else:
                        baseline.setdefault(rid, []).append(ev_lost)
                excess = 0.0
                for rid, losts in in_window.items():
                    base = sorted(baseline.get(rid, [0.0]))
                    med = base[len(base) // 2]
                    excess += sum(max(0.0, v - med) for v in losts)
                total = dw["dead_time_s"] + excess
                if total > 0:
                    out["charged_fraction"] = round(
                        dw["dead_time_s"] / total, 4
                    )
        if out["lost_s"] is None:
            out["lost_s"] = round(lost["heal"] + lost["quorum_server"]
                                  + lost["quorum_transport"], 3)
    elif reason == "region_stale":
        # Federated root declared a whole region dead: its child stopped
        # pushing digests for a full heartbeat timeout — the signature of
        # a correlated preemption wave (every group in the region dies at
        # once, so no single replica_stale names the blast radius).
        out["kind"] = "region_loss"
        out["region"] = incident.get("replica_id", "")
        out["replica"] = out["region"]
        out["cause"] = "dead_window"
        out["digest_age_ms"] = incident.get("detail")
        if events:
            from torchft_tpu_torch.obs import report

            commits = report.commit_timelines(events)
            faults = report.fault_times(events)
            dw = report.deadwindow(commits, faults)
            if dw["dead_time_s"] is not None:
                out["lost_s"] = round(dw["dead_time_s"], 3)
        if out["lost_s"] is None:
            out["lost_s"] = round(lost["heal"] + lost["quorum_server"]
                                  + lost["quorum_transport"], 3)
    elif reason == "alert:straggler":
        a = match_alert("straggler") or {}
        out["kind"] = "straggler"
        out["replica"] = _GROUP(a.get("replica_id")
                                or incident.get("replica_id", ""))
        out["cause"] = "compute_drag"
        out["ratio"] = a.get("ratio") or incident.get("detail")
        out["step_time_ms"] = a.get("step_time_ms")
        if a.get("ratio") and a.get("step_time_ms"):
            # Per-step drag the slow host imposes on the lockstep quorum:
            # its EWMA minus the cluster pace it was scored against.
            ratio = float(a["ratio"])
            if ratio > 1.0:
                out["drag_ms_per_step"] = round(
                    float(a["step_time_ms"]) * (1.0 - 1.0 / ratio), 1
                )
        out["lost_s"] = round(lost["stall"] + lost["other_ft"], 3)
    elif reason == "alert:slow_link":
        a = match_alert("slow_link") or {}
        src = a.get("src_replica_id") or incident.get("replica_id", "")
        dst = a.get("replica_id") or ""
        out["kind"] = "slow_link"
        out["replica"] = _GROUP(src)
        out["edge"] = {"src": _GROUP(src), "dst": _GROUP(dst)}
        out["cause"] = "wire"
        out["gbps"] = a.get("gbps")
        # Charge from the HOP-level attribution when the stream is
        # available: a degraded link's time lands in the ring engines'
        # wire/stall/shaping hop classes regardless of where the train
        # thread happened to block on it (the ledger's train-thread view
        # only charges the classes when the wait ran inside the
        # allreduce-blocking spans).
        charged = False
        if events:
            from torchft_tpu_torch.obs import report

            la = report.link_attribution(events)
            totals = la.get("totals") or {}
            hop_total = sum(totals.values())
            wire_hop = (
                totals.get("wire_s", 0.0)
                + totals.get("stall_s", 0.0)
                + totals.get("shaping_s", 0.0)
            )
            if hop_total > 0:
                out["lost_s"] = round(wire_hop, 3)
                out["charged_fraction"] = round(wire_hop / hop_total, 4)
                charged = True
        if not charged:
            wire_classes = lost["wire"] + lost["stall"] + lost["shaping"]
            out["lost_s"] = round(wire_classes, 3)
            total = sum(lost.values())
            if total > 0:
                out["charged_fraction"] = round(wire_classes / total, 4)
    elif reason == "alert:ec_coverage":
        a = match_alert("ec_coverage") or {}
        out["kind"] = "redundancy"
        out["replica"] = "cluster"
        out["cause"] = "ec_coverage"
        out["coverage"] = a.get("coverage")
        out["threshold"] = a.get("threshold")
        out["lost_s"] = 0.0  # redundancy loss costs no wall until a heal
    elif reason == "goodput_floor":
        out["kind"] = "goodput_dip"
        out["windowed_goodput"] = incident.get("detail")
        # The lighthouse's per-window attribution names the culprit when
        # the trigger carried one (each entity's per-cause delta scored
        # against its own trailing baseline — see docs/observability.md
        # "Culprit attribution"); a culprit-less record (old library, or
        # a genuinely diffuse dip) falls back to the cumulative-ledger
        # argmax the pre-attribution verdict used.
        culprit = str(incident.get("culprit_replica") or "")
        if culprit:
            out["replica"] = _GROUP(culprit)
            out["culprit_replica"] = culprit
            out["culprit_region"] = incident.get("culprit_region") or None
            out["cause"] = incident.get("dominant_cause") or None
            out["charged_seconds"] = incident.get("charged_seconds")
            out["delta_by_replica"] = incident.get("delta_by_replica") or {}
            cs = incident.get("charged_seconds")
            out["lost_s"] = round(float(cs), 3) if cs is not None else None
        else:
            out["replica"] = incident.get("replica_id", "cluster")
            worst = (
                max(lost, key=lambda c: lost[c]) if any(lost.values()) else None
            )
            out["cause"] = worst
            out["lost_s"] = round(lost[worst], 3) if worst else None
    elif reason == "alert:slo_burn":
        a = match_alert("slo_burn") or {}
        out["kind"] = "slo_burn"
        culprit = str(
            incident.get("culprit_replica") or a.get("replica_id") or ""
        )
        out["replica"] = _GROUP(culprit) if culprit else "cluster"
        out["culprit_replica"] = culprit or None
        out["culprit_region"] = incident.get("culprit_region") or None
        out["cause"] = (
            incident.get("dominant_cause") or a.get("dominant_cause") or None
        )
        out["burn_fast"] = a.get("burn_fast") or incident.get("detail")
        out["burn_slow"] = a.get("burn_slow")
        out["charged_seconds"] = (
            incident.get("charged_seconds") or a.get("charged_seconds")
        )
        out["delta_by_replica"] = incident.get("delta_by_replica") or {}
        cs = out["charged_seconds"]
        out["lost_s"] = round(float(cs), 3) if cs else None

    # Membership context: every verdict carries the churn timeline around
    # the incident — a goodput dip or kill during an elastic resize reads
    # differently from one in steady state (the resize cost is charged to
    # the ledger's "resize" cause, not the fault).  Most recent last;
    # bounded so a long churn soak does not bloat the manifest.
    changes = [
        {
            "step": ev.get("step"),
            "ts": ev.get("ts"),
            "replica_id": ev.get("replica_id"),
            "old_participants": ev.get("old_participants"),
            "new_participants": ev.get("new_participants"),
            "joined": ev.get("joined"),
            "left": ev.get("left"),
            "transition_s": ev.get("transition_s"),
            "mode": ev.get("mode"),
        }
        for ev in events
        if ev.get("event") == "membership_change"
    ]
    if changes:
        out["membership_changes"] = changes[-8:]
        out["resize_transition_s"] = round(
            sum(float(c.get("transition_s") or 0.0) for c in changes), 3
        )
    return out
