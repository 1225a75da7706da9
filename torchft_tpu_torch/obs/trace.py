"""Merged Chrome/Perfetto trace export: every replica's span stream on one
timeline.

The port's own copy of ``torchft_tpu/obs/trace.py``: the same record and
field names, registries, environment knobs and defaults, so either
package's consumers read either package's streams (held against the
JAX package's by tests/test_torch_obs.py).  Paths named below are the
JAX package's where the port has no counterpart.

Input is the metrics JSONL documented in torchft_tpu/metrics.py (``span``,
``step_summary``, ``fault``, ``drain_*`` records from any number of
replicas, one file or many).  Output is Chrome trace-event JSON — load it
in Perfetto (ui.perfetto.dev) or chrome://tracing — with:

- one **process** per replica group (the stable ``<group>`` prefix of
  ``<group>:<uuid>`` ids) and one **track (thread)** per incarnation, so a
  killed-and-restarted group shows its incarnations stacked in one lane;
  overlapped phases (the donor-side background ``snapshot``) get their own
  sub-track so the main track stays strictly sequential;
- phase **slices** (``X`` events) named by span phase, with ``step`` /
  ``slice_gen`` / ``ok`` in args;
- fault / drain / alert **instant** events, so a kill or a cooperative
  handoff is visible at the exact moment the goodput accounting charges it;
- **clock alignment** via the ``step_summary`` commit barrier: each
  committed step's summaries are written right after the same two-phase
  commit vote on every replica, so the cross-replica median of their wall
  timestamps estimates per-replica clock/write skew; each replica's events
  are shifted by its median offset before merging.  (Within one stream
  this is a no-op; across hosts it removes NTP-level skew without any
  shared clock.)

Span records carry their END timestamp (they are written when the phase
finishes); the slice start is ``ts - duration``.  Slices on one track are
clamped to be non-overlapping (later start wins), which keeps the trace
valid even when the quorum thread and the train thread measured
concurrently.

The CLI wrapper is ``python -m torchft_tpu_torch.tools.trace_export``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "PHASE_TRACKS",
    "build_trace",
    "validate_trace",
    "synthetic_stream",
    "synthetic_flight_stream",
    "synthetic_hop_stream",
    "hops_to_stream",
    "load_hops_dump",
]

# Track mapping for every registered span phase (obs/spans.py PHASES):
# "main" renders on the incarnation's sequential phase track, "background"
# on its overlapped sub-track (tid+1).  Every PHASES entry must appear
# here — a new phase without a mapping would silently land on the main
# track and could corrupt its non-overlap clamping.  Grep-pinned by
# tests/test_flight.py (static registry check).
PHASE_TRACKS = {
    "quorum": "main",
    "configure": "main",
    "heal": "main",
    "allreduce_d2h": "main",
    "allreduce_h2d": "main",
    "allreduce_merge": "main",
    "commit_vote": "main",
    "snapshot": "background",
    # The semisync engine's fragment rounds run on its worker thread,
    # concurrent with inner compute — same sub-track as the snapshotter.
    "outer_sync": "background",
    # Erasure-shard encode rides the snapshotter thread (background); the
    # reconstruction fallback blocks the healing quorum thread (main).
    "ec_encode": "background",
    "ec_reconstruct": "main",
}

# Events rendered as instant markers on the emitting replica's track (or
# the global track for the benchmark's fault schedule).
_INSTANT_EVENTS = (
    "fault",
    "drain_notice",
    "drain_complete",
    "drain_handoff",
    "drain_donor_exit",
    "alert",
    "link_shaped",
    "link_alert",
    "straggler_injected",
    "heal_start",
    "error",
)


def _group(replica_id: str) -> str:
    return str(replica_id).split(":", 1)[0]


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    return ordered[(len(ordered) - 1) // 2] if ordered else 0.0


def _clock_offsets(events: Sequence[dict]) -> Dict[str, float]:
    """Per-replica wall-clock offset estimated from the step_summary commit
    barrier: all replicas emit the summary for a committed step right after
    the same commit vote, so their timestamps SHOULD agree; the per-replica
    median deviation from the cross-replica median is that replica's skew."""
    by_step: Dict[Tuple[int, int], Dict[str, float]] = {}
    for ev in events:
        if ev.get("event") != "step_summary" or not ev.get("committed"):
            continue
        rid = str(ev.get("replica_id", ""))
        key = (int(ev.get("slice_gen", 0) or 0), int(ev.get("step", -1)))
        # First summary per (step, replica): retried steps re-summarize.
        by_step.setdefault(key, {}).setdefault(rid, float(ev.get("ts", 0.0)))
    deltas: Dict[str, List[float]] = {}
    for _, per_rid in by_step.items():
        if len(per_rid) < 2:
            continue  # no cross-replica barrier to compare against
        ref = _median(list(per_rid.values()))
        for rid, ts in per_rid.items():
            deltas.setdefault(rid, []).append(ts - ref)
    return {rid: _median(ds) for rid, ds in deltas.items()}


def build_trace(events: Sequence[dict], align: bool = True) -> dict:
    """Builds the Chrome trace-event dict from merged metrics events."""
    offsets = _clock_offsets(events) if align else {}

    def corrected(ev: dict) -> float:
        return float(ev.get("ts", 0.0)) - offsets.get(
            str(ev.get("replica_id", "")), 0.0
        )

    spans = [ev for ev in events if ev.get("event") == "span"]
    instants = [ev for ev in events if ev.get("event") in _INSTANT_EVENTS]
    # Data-plane hop records (the ring engines' flight recorder,
    # hops_to_stream / hops_*.json dumps): rendered as per-(tier, lane)
    # tracks inside the replica's process, time-aligned with its phase
    # tracks — the view that shows whether comms actually overlap compute.
    hops = [ev for ev in events if ev.get("event") == "hop"]
    # Control-plane stream (obs/flight.py flight_to_stream): RPC spans and
    # state instants from the native servers' flight recorders, rendered
    # on their own process next to the worker tracks.
    cp_rpcs = [ev for ev in events if ev.get("event") == "cp_rpc"]
    cp_instants = [ev for ev in events if ev.get("event") == "cp_event"]
    if not spans and not instants and not hops and not cp_rpcs and not cp_instants:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    # Only span- or hop-emitting replicas get tracks; instants from
    # anything else (the benchmark's fault schedule, the launcher)
    # render on the global pid-0 lane instead of minting a phantom replica.
    first_seen: Dict[str, float] = {}
    for ev in spans:
        rid = str(ev.get("replica_id", ""))
        ts = corrected(ev)
        if rid not in first_seen or ts < first_seen[rid]:
            first_seen[rid] = ts
    for ev in hops:
        rid = str(ev.get("replica_id", ""))
        ts = corrected(ev)
        if rid not in first_seen or ts < first_seen[rid]:
            first_seen[rid] = ts
    for ev in instants:
        rid = str(ev.get("replica_id", ""))
        if rid in first_seen:
            first_seen[rid] = min(first_seen[rid], corrected(ev))
    groups = sorted({_group(rid) for rid in first_seen})
    pid_of = {g: i + 1 for i, g in enumerate(groups)}
    tid_of: Dict[str, int] = {}
    for g in groups:
        incarnations = sorted(
            (rid for rid in first_seen if _group(rid) == g),
            key=lambda rid: (first_seen[rid], rid),
        )
        for i, rid in enumerate(incarnations):
            tid_of[rid] = 1 + 2 * i  # odd = phases, even (tid+1) = background

    # Control-plane processes: one pid per source after the worker groups,
    # one track per (RPC method, peer) pair — frames on one CONNECTION are
    # handled strictly sequentially by the server, so per-peer lanes are
    # genuinely non-overlapping, whereas a per-method-only lane is not
    # (two groups' Quorum handlers block through the same formation window
    # concurrently, and the non-overlap clamp would collapse the second
    # span to zero).  tid 0 carries the state-transition instants.
    # Control-plane timestamps use the server's wall clock with no
    # per-replica offset: worker offsets are corrections TOWARD the
    # cross-replica median, which is the same frame a one-host control
    # plane's clock sits in.
    cp_sources = sorted(
        {str(ev.get("source", "control-plane")) for ev in cp_rpcs + cp_instants}
    )
    cp_pid_of = {s: len(groups) + 1 + i for i, s in enumerate(cp_sources)}
    cp_lanes: Dict[str, List[Tuple[str, str]]] = {
        s: sorted(
            {
                (str(ev.get("method", "?")), str(ev.get("peer", "")))
                for ev in cp_rpcs
                if str(ev.get("source", "control-plane")) == s
            }
        )
        for s in cp_sources
    }
    cp_tid_of = {
        (s, m, p): 1 + 2 * i
        for s in cp_sources
        for i, (m, p) in enumerate(cp_lanes[s])
    }

    # Data-plane lanes: one track per (replica, tier, lane) carrying hop
    # slices, tid-spaced far above the phase/background pair so
    # incarnation tids can never collide (odd so the validate rule "odd
    # tids carry their own thread metadata" applies to them directly).
    dp_lanes: Dict[str, List[Tuple[int, int]]] = {}
    for ev in hops:
        rid = str(ev.get("replica_id", ""))
        if rid not in tid_of:
            continue
        key = (int(ev.get("tier", 0) or 0), int(ev.get("lane", 0) or 0))
        lanes = dp_lanes.setdefault(rid, [])
        if key not in lanes:
            lanes.append(key)
    dp_tid_of: Dict[Tuple[str, int, int], int] = {}
    for rid, lanes in dp_lanes.items():
        for i, (tier, lane) in enumerate(sorted(lanes)):
            dp_tid_of[(rid, tier, lane)] = 100 * tid_of[rid] + 1 + 2 * i

    t0 = min(
        min(
            (corrected(ev) - float(ev.get("duration_ms", 0.0)) / 1e3 for ev in spans),
            default=float("inf"),
        ),
        min((corrected(ev) for ev in hops), default=float("inf")),
        min((corrected(ev) for ev in instants), default=float("inf")),
        min(
            (
                float(ev.get("ts", 0.0)) - float(ev.get("duration_ms", 0.0)) / 1e3
                for ev in cp_rpcs
            ),
            default=float("inf"),
        ),
        min((float(ev.get("ts", 0.0)) for ev in cp_instants), default=float("inf")),
    )

    def us(ts: float) -> float:
        return round((ts - t0) * 1e6, 1)

    out: List[dict] = []
    for g in groups:
        out.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": pid_of[g],
                "tid": 0,
                "args": {"name": f"replica group {g}"},
            }
        )
    out.append(
        {
            "ph": "M",
            "name": "process_name",
            "pid": 0,
            "tid": 0,
            "args": {"name": "bench driver / faults"},
        }
    )
    for s in cp_sources:
        out.append(
            {
                "ph": "M",
                "name": "process_name",
                "pid": cp_pid_of[s],
                "tid": 0,
                "args": {"name": f"control plane {s}"},
            }
        )
        for m, p in cp_lanes[s]:
            out.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": cp_pid_of[s],
                    "tid": cp_tid_of[(s, m, p)],
                    "args": {"name": f"{s} {m} {p}".rstrip()},
                }
            )
    for rid, tid in sorted(tid_of.items()):
        pid = pid_of[_group(rid)]
        out.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tid,
                "args": {"name": rid},
            }
        )
    _tier_names = {0: "flat", 1: "row", 2: "col"}
    for (rid, tier, lane), tid in sorted(dp_tid_of.items()):
        out.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid_of[_group(rid)],
                "tid": tid,
                "args": {
                    "name": f"{rid} dp:{_tier_names.get(tier, tier)} lane{lane}"
                },
            }
        )

    # Phase slices, clamped non-overlapping per track.
    per_track: Dict[Tuple[int, int], List[dict]] = {}
    for ev in spans:
        rid = str(ev.get("replica_id", ""))
        if rid not in tid_of:
            continue
        pid = pid_of[_group(rid)]
        phase = str(ev.get("phase", "?"))
        tid = tid_of[rid] + (
            1 if PHASE_TRACKS.get(phase, "main") == "background" else 0
        )
        dur_s = float(ev.get("duration_ms", 0.0)) / 1e3
        end = corrected(ev)
        args = {
            k: ev[k]
            for k in ("step", "slice_gen", "src_rank")
            if ev.get(k) is not None
        }
        if ev.get("ok") is False:
            args["ok"] = False
        per_track.setdefault((pid, tid), []).append(
            {
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "name": phase,
                "cat": "phase",
                "_start": end - dur_s,
                "_end": end,
                "args": args,
            }
        )
    # Data-plane hop slices: one per recorded hop, on the replica's
    # (tier, lane) track.  ``ts`` is the hop START (unlike span records,
    # whose ts is the end); duration is the hop's full wait+combine.
    # Stripes sharing a lane can interleave, so hop slices ride the same
    # non-overlap clamp as phases.
    for ev in hops:
        rid = str(ev.get("replica_id", ""))
        key = (
            rid,
            int(ev.get("tier", 0) or 0),
            int(ev.get("lane", 0) or 0),
        )
        tid = dp_tid_of.get(key)
        if tid is None:
            continue
        pid = pid_of[_group(rid)]
        start = corrected(ev)
        dur_s = (
            float(ev.get("send_s", 0.0))
            + float(ev.get("recv_s", 0.0))
            + float(ev.get("comb_s", 0.0))
        )
        tag = int(ev.get("tag", 0) or 0)
        sub = tag % 8
        phase = {1: "rs", 2: "ag", 3: "gather", 4: "rs", 5: "ag"}.get(sub, "hop")
        per_track.setdefault((pid, tid), []).append(
            {
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "name": f"hop:{phase}",
                "cat": "hop",
                "_start": start,
                "_end": start + dur_s,
                "args": {
                    k: ev[k]
                    for k in ("tag", "send_s", "recv_s", "comb_s", "nbytes")
                    if ev.get(k) is not None
                },
            }
        )
    # Control-plane RPC slices: per (source, method, peer) lane, same
    # clamping (a no-op within a lane — see the lane-layout comment).
    for ev in cp_rpcs:
        s = str(ev.get("source", "control-plane"))
        m = str(ev.get("method", "?"))
        pid = cp_pid_of[s]
        tid = cp_tid_of[(s, m, str(ev.get("peer", "")))]
        dur_s = float(ev.get("duration_ms", 0.0)) / 1e3
        end = float(ev.get("ts", 0.0))
        args = {
            k: ev[k]
            for k in ("trace_id", "peer", "status")
            if ev.get(k) not in (None, "")
        }
        per_track.setdefault((pid, tid), []).append(
            {
                "ph": "X",
                "pid": pid,
                "tid": tid,
                "name": m,
                "cat": "cp_rpc",
                "_start": end - dur_s,
                "_end": end,
                "args": args,
            }
        )
    for (_, _), slices in per_track.items():
        slices.sort(key=lambda s: (s["_start"], s["_end"]))
        prev_end = float("-inf")
        for s in slices:
            start = max(s["_start"], prev_end)
            end = max(s["_end"], start)
            prev_end = end
            s["ts"] = us(start)
            s["dur"] = round((end - start) * 1e6, 1)
            del s["_start"], s["_end"]
            out.append(s)

    # Instant markers.
    for ev in instants:
        rid = str(ev.get("replica_id", ""))
        kind = str(ev.get("event"))
        name = kind
        if kind == "fault":
            name = f"fault:{ev.get('kind', '?')} g{ev.get('group', '?')}"
        args = {
            k: v
            for k, v in ev.items()
            if k
            not in ("ts", "t_mono", "schema", "event", "replica_id")
            and v is not None
        }
        if rid in tid_of:
            out.append(
                {
                    "ph": "i",
                    "s": "t",
                    "pid": pid_of[_group(rid)],
                    "tid": tid_of[rid],
                    "name": name,
                    "cat": "event",
                    "ts": us(corrected(ev)),
                    "args": args,
                }
            )
        else:
            # Driver records (fault schedule) are cluster-scoped.
            out.append(
                {
                    "ph": "i",
                    "s": "g",
                    "pid": 0,
                    "tid": 0,
                    "name": name,
                    "cat": "event",
                    "ts": us(corrected(ev)),
                    "args": args,
                }
            )

    # Control-plane state transitions: instants on the source's tid 0.
    for ev in cp_instants:
        s = str(ev.get("source", "control-plane"))
        args = {
            k: v
            for k, v in ev.items()
            if k not in ("ts", "event", "source", "kind") and v not in (None, "")
        }
        out.append(
            {
                "ph": "i",
                "s": "t",
                "pid": cp_pid_of[s],
                "tid": 0,
                "name": f"cp:{ev.get('kind', '?')}",
                "cat": "cp_event",
                "ts": us(float(ev.get("ts", 0.0))),
                "args": args,
            }
        )

    out.sort(key=lambda ev: (ev.get("ts", 0.0), ev.get("pid", 0), ev.get("tid", 0)))
    return {
        "traceEvents": out,
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "tpu-ft tools/trace_export.py",
            "replicas": {rid: f"pid {pid_of[_group(rid)]} tid {tid}"
                         for rid, tid in tid_of.items()},
            "control_plane": {s: f"pid {cp_pid_of[s]}" for s in cp_sources},
            "clock_offsets_s": {k: round(v, 6) for k, v in offsets.items()},
        },
    }


def validate_trace(trace: dict) -> List[str]:
    """Structural checks on a Chrome trace-event dict; returns problems
    (empty list = valid).  Pinned by tests/test_obs.py and --quick."""
    problems: List[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents is not a list"]
    tracks: Dict[Tuple[int, int], float] = {}
    thread_names: Dict[Tuple[int, int], str] = {}
    for i, ev in enumerate(evs):
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            problems.append(f"event {i}: unexpected ph {ph!r}")
            continue
        if ph == "M":
            if ev.get("name") == "thread_name":
                key = (ev.get("pid"), ev.get("tid"))
                name = ev.get("args", {}).get("name", "")
                if key in thread_names:
                    problems.append(f"duplicate thread metadata for {key}")
                thread_names[key] = name
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            problems.append(f"event {i} ({ev.get('name')}): bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                problems.append(f"event {i} ({ev.get('name')}): bad dur {dur!r}")
                continue
            key = (ev.get("pid"), ev.get("tid"))
            prev_end = tracks.get(key, float("-inf"))
            if ts < prev_end - 0.5:  # 0.5 us slack for rounding
                problems.append(
                    f"event {i} ({ev.get('name')}): overlaps previous slice "
                    f"on track {key} ({ts} < {prev_end})"
                )
            tracks[key] = max(prev_end, ts + dur)
    # One named track per replica: every (pid, tid) that carries slices on
    # an odd tid (the phases track) must have thread metadata.
    for (pid, tid) in tracks:
        base = (pid, tid if tid % 2 == 1 else tid - 1)
        if pid != 0 and base not in thread_names:
            problems.append(f"track {(pid, tid)} has slices but no thread_name")
    names = list(thread_names.values())
    if len(names) != len(set(names)):
        problems.append("replica track names are not unique")
    return problems


def synthetic_stream(
    n_replicas: int = 2, steps: int = 4, base_ts: float = 1_700_000_000.0
) -> List[dict]:
    """Deterministic multi-replica stream for --quick and tests: per step a
    quorum span, an allreduce_merge span, a commit and a step_summary per
    replica; replica 1 pays a heal on step 2; one kill fault and one drain
    instant ride along."""
    events: List[dict] = []
    step_s = 1.0
    for r in range(n_replicas):
        rid = f"{r}:{'abcdef'[r % 6]}{r}"
        skew = 0.002 * r  # small per-replica clock skew the aligner removes
        for step in range(1, steps + 1):
            end = base_ts + step * step_s + skew
            quorum_ms = 40.0 + 5 * r
            from torchft_tpu_torch.obs.flight import mint_trace_id

            events.append(
                {
                    "ts": end - 0.5,
                    "replica_id": rid,
                    "event": "span",
                    "phase": "quorum",
                    "step": step,
                    "slice_gen": 0,
                    "duration_ms": quorum_ms,
                    "trace_id": mint_trace_id(0, rid, step),
                }
            )
            if r == 1 and step == 2:
                events.append(
                    {
                        "ts": end - 0.1,
                        "replica_id": rid,
                        "event": "span",
                        "phase": "heal",
                        "step": step,
                        "slice_gen": 0,
                        "duration_ms": 350.0,
                        "src_rank": 0,
                    }
                )
            events.append(
                {
                    "ts": end,
                    "replica_id": rid,
                    "event": "span",
                    "phase": "allreduce_merge",
                    "step": step,
                    "slice_gen": 0,
                    "duration_ms": 20.0,
                }
            )
            events.append(
                {
                    "ts": end,
                    "replica_id": rid,
                    "event": "commit",
                    "step": step,
                    "committed": True,
                }
            )
            events.append(
                {
                    "ts": end + 0.001,
                    "replica_id": rid,
                    "event": "step_summary",
                    "step": step,
                    "slice_gen": 0,
                    "committed": True,
                    "phases": {"quorum": quorum_ms, "allreduce_merge": 20.0},
                }
            )
    events.append(
        {
            "ts": base_ts + 2.4,
            "replica_id": "bench-driver",
            "event": "fault",
            "kind": "kill",
            "group": "1",
        }
    )
    events.append(
        {
            "ts": base_ts + 3.2,
            "replica_id": "0:a0",
            "event": "drain_notice",
            "source": "supervisor",
        }
    )
    events.sort(key=lambda ev: ev["ts"])
    return events


def synthetic_flight_stream(
    n_replicas: int = 2, steps: int = 4, base_ts: float = 1_700_000_000.0
) -> List[dict]:
    """Control-plane companion to :func:`synthetic_stream`: the lighthouse
    flight recorder's view of the same run — one server-side Quorum RPC
    span per (replica, step) whose trace id matches the worker stream's
    quorum span, periodic Heartbeat spans, and a ``quorum_formed``
    transition when the membership first assembles.  Used by
    ``tools/trace_export.py --quick`` and the tier-1 trace tests."""
    from torchft_tpu_torch.obs.flight import mint_trace_id

    source = "lighthouse:29510"
    events: List[dict] = []
    members = [f"{r}:{'abcdef'[r % 6]}{r}" for r in range(n_replicas)]
    events.append(
        {
            "event": "cp_event",
            "source": source,
            "ts": base_ts + 0.95,
            "kind": "quorum_formed",
            "d_quorum_id": 1,
            "d_members": members,
            "d_joined": members,
            "d_left": [],
            "d_formation_ms": 42.0,
        }
    )
    for r, rid in enumerate(members):
        for step in range(1, steps + 1):
            end = base_ts + step * 1.0 + 0.002 * r - 0.46
            quorum_ms = 38.0 + 5 * r
            events.append(
                {
                    "event": "cp_rpc",
                    "source": source,
                    "ts": end,
                    "method": "Quorum",
                    "status": 0,
                    "peer": f"127.0.0.1:5{r}000",
                    "trace_id": mint_trace_id(0, rid, step),
                    "duration_ms": quorum_ms,
                }
            )
            events.append(
                {
                    "event": "cp_rpc",
                    "source": source,
                    "ts": end + 0.1,
                    "method": "Heartbeat",
                    "status": 0,
                    "peer": f"127.0.0.1:5{r}000",
                    "trace_id": mint_trace_id(0, rid, step),
                    "duration_ms": 0.05,
                }
            )
    events.sort(key=lambda ev: ev["ts"])
    return events


def load_hops_dump(path: str) -> dict:
    """Loads one ``hops_<replica>.json`` dump (Manager shutdown with
    ``TPUFT_HOP_DUMP_DIR`` set, or a bench's direct
    ``TCPCollective.hop_records()`` write).  Raises ValueError on a
    malformed document."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    if not isinstance(doc, dict) or not isinstance(doc.get("records"), list):
        raise ValueError(f"{path}: not a hop dump (missing records list)")
    return doc


def hops_to_stream(dump: dict) -> List[dict]:
    """Converts one hop dump into ``event: "hop"`` records for
    :func:`build_trace` — each carries the replica id plus the raw
    RingHopRecord fields (hop-start wall-clock ``ts``)."""
    rid = str(dump.get("replica_id", ""))
    out: List[dict] = []
    for rec in dump.get("records", []):
        if not isinstance(rec, dict) or "ts" not in rec:
            continue
        ev = dict(rec)
        ev["event"] = "hop"
        ev["replica_id"] = rid
        out.append(ev)
    return out


def synthetic_hop_stream(
    n_replicas: int = 2, steps: int = 4, base_ts: float = 1_700_000_000.0
) -> List[dict]:
    """Data-plane companion to :func:`synthetic_stream`: per (replica,
    step) a short burst of rs/ag hops on two lanes of the flat tier, in
    the window the worker stream's allreduce_merge span covers.  Used by
    ``tools/trace_export.py --quick`` and the tier-1 trace tests."""
    events: List[dict] = []
    for r in range(n_replicas):
        rid = f"{r}:{'abcdef'[r % 6]}{r}"
        for step in range(1, steps + 1):
            end = base_ts + step * 1.0 + 0.002 * r
            for lane in (0, 1):
                for h, sub in enumerate((1, 1, 2, 2)):  # rs, rs, ag, ag
                    events.append(
                        {
                            "event": "hop",
                            "replica_id": rid,
                            "ts": end - 0.4 + 0.08 * h + 0.01 * lane,
                            "tier": 0,
                            "lane": lane,
                            "tag": 65 * 8 * step + lane * 8 + sub,
                            "send_s": 0.004,
                            "recv_s": 0.05,
                            "comb_s": 0.002 if sub == 1 else 0.0,
                            "nbytes": 1 << 16,
                        }
                    )
    events.sort(key=lambda ev: ev["ts"])
    return events


def export(
    paths: Sequence[str],
    out_path: str,
    align: bool = True,
    stats: Optional[dict] = None,
    flight_paths: Sequence[str] = (),
    hops_paths: Sequence[str] = (),
) -> dict:
    """Reads JSONL streams (plus optional flight-recorder and hop-timeline
    dumps), builds the trace, writes ``out_path``.  Returns a summary dict
    (events, replicas, control-plane tracks, data-plane tracks,
    problems)."""
    from torchft_tpu_torch.obs.report import read_events

    read_stats: dict = {}
    events = read_events(paths, stats=read_stats)
    flight_skipped: List[str] = []
    for fp in flight_paths:
        # A torn dump (server killed mid-write never happens — the dump is
        # atomic — but a foreign/corrupt file can be handed in) is skipped
        # and counted, like garbage JSONL lines.
        try:
            from torchft_tpu_torch.obs.flight import flight_to_stream, load_flight_dump

            events.extend(flight_to_stream(load_flight_dump(fp)))
        except (OSError, ValueError):
            flight_skipped.append(fp)
    hops_skipped: List[str] = []
    for hp in hops_paths:
        try:
            events.extend(hops_to_stream(load_hops_dump(hp)))
        except (OSError, ValueError):
            hops_skipped.append(hp)
    events.sort(key=lambda ev: float(ev.get("ts", 0.0)))
    trace = build_trace(events, align=align)
    problems = validate_trace(trace)
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(trace, f)
    replicas = trace.get("otherData", {}).get("replicas", {})
    control_plane = trace.get("otherData", {}).get("control_plane", {})
    dp_tracks = sum(
        1
        for ev in trace["traceEvents"]
        if ev.get("ph") == "M"
        and ev.get("name") == "thread_name"
        and " dp:" in str(ev.get("args", {}).get("name", ""))
    )
    summary = {
        "out": out_path,
        "input_events": len(events),
        "skipped_lines": read_stats.get("skipped_lines", 0),
        "trace_events": len(trace["traceEvents"]),
        "replicas": len(replicas),
        "control_plane_tracks": len(control_plane),
        "data_plane_tracks": dp_tracks,
        "unreadable_flight_dumps": flight_skipped,
        "unreadable_hop_dumps": hops_skipped,
        "problems": problems,
        "ok": not problems,
    }
    if stats is not None:
        stats.update(summary)
    return summary
