"""Goodput attribution: merge per-replica JSONL streams into a per-step
cluster timeline and say where the wall-clock went.

The port's own copy of ``torchft_tpu/obs/report.py``: the same record and
field names, registries, environment knobs and defaults, so either
package's consumers read either package's streams (held against the
JAX package's by tests/test_torch_obs.py).  Paths named below are the
JAX package's where the port has no counterpart.

CLI::

    python -m torchft_tpu_torch.obs.report metrics.jsonl [more.jsonl ...] [--json]

Input is the event stream documented in torchft_tpu/metrics.py (all
replicas may share one file — O_APPEND keeps lines atomic — or each may
have its own).  Output:

- a per-step phase attribution table: for every committed step, the
  slowest replica's wall time split into productive compute vs the FT
  phases (quorum wait, configure, heal, allreduce d2h, allreduce merge,
  commit vote) and the critical-path phase — the bucket that dominated the
  slowest replica;
- cluster totals: wall time classified productive / quorum-wait / heal /
  drain / idle per group and summed;
- the dead-window goodput fraction, computed by :func:`deadwindow` — the
  SAME function ``bench.py`` calls for its headline, so the benchmark
  number and this report cannot drift apart (pinned by
  tests/test_bench_contract.py).

Timing discipline: durations inside one replica's stream use ``t_mono``
(NTP-step-immune); cross-replica alignment (t0, spans, gaps between
incarnations — which never share a monotonic origin) uses ``ts``.

Faults are part of the stream: bench.py writes a ``fault`` record (kind
kill|drain, group=victim) at injection time, so this tool charges the same
fault timeline the benchmark charged.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from torchft_tpu_torch.obs.spans import OVERLAPPED_PHASES

__all__ = [
    "read_events",
    "commit_timelines",
    "fault_times",
    "election_windows",
    "deadwindow",
    "attribute",
    "render",
]


def read_events(
    paths: Sequence[str], stats: Optional[dict] = None
) -> List[dict]:
    """Reads + merges JSONL streams, sorted by wall-clock ``ts``.

    Garbage lines never raise: a writer killed mid-record leaves a
    truncated trailing line, a torn multi-process write can interleave two
    records, and stray text parses to a non-dict JSON value — all are
    skipped and COUNTED, with one warning per file, so a kill-run stream is
    always readable and the caller can see how much was lost.  Pass
    ``stats`` (a dict, filled in place) to receive ``skipped_lines``,
    ``skipped_by_file`` and ``unreadable_files`` — the last lists files
    that could not be opened OR failed mid-read (flaky storage); a
    partially read file keeps its already-parsed events and its skipped
    count.  The CLI surfaces these in its ``--json`` output.
    """
    events: List[dict] = []
    skipped_by_file: Dict[str, int] = {}
    unreadable: List[str] = []
    for path in paths:
        skipped = 0
        try:
            f = open(path, "rb")
        except OSError:
            unreadable.append(path)
            continue
        with f:
            try:
                for line in f:
                    if not line.strip():
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        skipped += 1
                        continue
                    if not isinstance(ev, dict):
                        # json.loads accepts bare scalars; a corrupted line
                        # that happens to parse must not crash consumers
                        # doing ev.get(...).
                        skipped += 1
                        continue
                    events.append(ev)
            except OSError:
                # Mid-file I/O failure: keep what parsed, keep the skip
                # count, and flag the file so the caller knows the stream
                # is incomplete.
                unreadable.append(path)
        if skipped:
            skipped_by_file[path] = skipped
            print(
                f"warning: {path}: skipped {skipped} unparseable line(s) "
                "(truncated or torn writes)",
                file=sys.stderr,
            )
    if stats is not None:
        stats["skipped_lines"] = sum(skipped_by_file.values())
        stats["skipped_by_file"] = skipped_by_file
        stats["unreadable_files"] = unreadable
    events.sort(key=lambda ev: float(ev.get("ts", 0.0)))
    return events


def _group(replica_id: str) -> str:
    """Replica ids are "<group>:<uuid>" with a fresh uuid per incarnation;
    the group prefix is the stable identity."""
    return str(replica_id).split(":", 1)[0]


def commit_timelines(events: Sequence[dict]) -> Dict[str, List[float]]:
    """{group: sorted committed-commit ts list} across all incarnations."""
    commits: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("event") == "commit" and ev.get("committed"):
            commits.setdefault(_group(ev.get("replica_id", "")), []).append(
                float(ev["ts"])
            )
    for ts_list in commits.values():
        ts_list.sort()
    return commits


def fault_times(events: Sequence[dict]) -> List[Tuple[float, str]]:
    """[(ts, victim group)] from ``fault`` records (written by bench.py).

    ``straggler`` faults are excluded: an injected slowdown is not a death
    — the victim keeps committing (slowly), so charging its commit gap as
    a dead window would fabricate downtime.  The straggler scenario's own
    accounting (detection latency, post-injection rate) lives in bench.py.

    ``lighthouse`` faults are excluded too: a lighthouse kill is a CONTROL
    PLANE fault, not a worker death — no replica group's commit timeline
    belongs to it (charging it here would mark the trial unrecovered
    against a group that never existed).  Leader-election dead time is
    instead charged like quorum wait via :func:`election_windows`.
    """
    return [
        (float(ev["ts"]), str(ev.get("group", "")))
        for ev in events
        if ev.get("event") == "fault"
        and str(ev.get("kind")) not in ("straggler", "lighthouse")
    ]


# THE reset-detection rule for cumulative-per-configure counters, shared
# with the live goodput ledger (torchft_tpu/obs/ledger.py) so the post-hoc
# rollups here (data_plane, link_attribution) and the ledger's per-step
# hop deltas cannot diverge on what a reconfigure looks like.
from torchft_tpu_torch.obs.ledger import epoch_bank as _epoch_bank
from torchft_tpu_torch.obs.ledger import ledger_rollup as _ledger_rollup


def data_plane(events: Sequence[dict]) -> dict:
    """Cross-topology data-plane rollup from step_summary records.

    ``allreduce_payload_bytes`` sums the per-step payload accounting, which
    the Manager computes through the collective's ``wire_nbytes`` probe —
    the single telemetry source, so a flat-ring run and a ring2d run of the
    same workload read comparable totals (and the derived
    ``tpuft_allreduce_gb_per_s`` gauge stays comparable too).
    ``tier_wire_bytes`` attributes actual wire traffic per ring tier
    ("flat" = the flat ring's next-direction lanes; "row"/"col" = the 2D
    topology's nested tiers) from the lane_stats snapshot each step_summary
    embeds.  Those counters are CUMULATIVE per configure() — they RESET on
    every quorum reconfiguration — so the rollup accumulates per
    (replica, tier) epochs: a snapshot that drops below the previous one
    closes the old epoch (its high-water mark is banked) and opens a new
    one; the total is banked epochs plus the live epoch's high-water mark.
    A plain per-replica max would silently drop all traffic that predates
    a reconfiguration — precisely the fault runs this report analyzes."""
    payload: Dict[str, int] = {}
    # rid -> tier -> [closed-epoch sum, current-epoch high-water mark]
    tier_acc: Dict[str, Dict[str, List[int]]] = {}
    topologies: set = set()
    for ev in events:
        if ev.get("event") != "step_summary":
            continue
        rid = str(ev.get("replica_id", ""))
        nbytes = ev.get("allreduce_bytes")
        if nbytes:
            payload[rid] = payload.get(rid, 0) + int(nbytes)
        lanes = ev.get("allreduce_lanes")
        if isinstance(lanes, dict):
            topologies.add(str(lanes.get("topology", "ring")))
            tiers = {"flat": sum(lanes.get("sent") or [])}
            for name, tier in (lanes.get("tiers") or {}).items():
                tiers[name] = sum(tier.get("sent") or [])
            acc = tier_acc.setdefault(rid, {})
            for name, v in tiers.items():
                _epoch_bank(acc.setdefault(name, [0, 0]), int(v))
    tier_totals: Dict[str, int] = {}
    for tiers in tier_acc.values():
        for name, (closed, cur) in tiers.items():
            tier_totals[name] = tier_totals.get(name, 0) + closed + cur
    return {
        "allreduce_payload_bytes": sum(payload.values()),
        "per_replica_payload_bytes": dict(sorted(payload.items())),
        "tier_wire_bytes": dict(sorted(tier_totals.items())),
        "topologies": sorted(topologies),
    }


def link_attribution(events: Sequence[dict]) -> dict:
    """Data-plane wall attribution from the hop telemetry each
    step_summary's ``allreduce_lanes["hops"]`` snapshot embeds: splits the
    allreduce wall per replica into four classes —

    * ``wire_s``   — send-blocked time net of modeled shaping (real
      serialization/backpressure on the OUTBOUND edge: the localizing
      signal when a link degrades),
    * ``stall_s``  — recv-wait (blocked on the inbound edge: upstream
      serialization + propagation + peer pace, the equalized symptom),
    * ``combine_s`` — decode + elementwise combine (host CPU),
    * ``shaping_s`` — time slept in the LinkShaper's virtual-time pacer
      (bench-only modeled serialization; 0 on unshaped links).

    The hop counters are CUMULATIVE per configure() and reset on every
    quorum reconfiguration, so accumulation is epoch-banked exactly like
    :func:`data_plane` (a snapshot below its predecessor closes the old
    epoch).  ``fractions`` normalizes over the four classes' sum — the
    bench's degraded cell pins that the added wall of a shaped edge lands
    in wire+shaping/stall, not combine."""
    keys = ("send_block_s", "recv_wait_s", "combine_s", "shape_s", "hops")
    # rid -> key -> [closed-epoch sum, current-epoch high-water mark]
    acc: Dict[str, Dict[str, List[float]]] = {}
    for ev in events:
        if ev.get("event") != "step_summary":
            continue
        lanes = ev.get("allreduce_lanes")
        if not isinstance(lanes, dict):
            continue
        hops = lanes.get("hops")
        if not isinstance(hops, dict):
            continue
        rid = str(ev.get("replica_id", ""))
        cur = {k: 0.0 for k in keys}
        for tier in hops.values():
            for k in keys:
                cur[k] += float(tier.get(k, 0) or 0)
        slots = acc.setdefault(rid, {})
        for k, v in cur.items():
            _epoch_bank(slots.setdefault(k, [0.0, 0.0]), v)
    per_replica: Dict[str, dict] = {}
    totals = {"wire_s": 0.0, "stall_s": 0.0, "combine_s": 0.0, "shaping_s": 0.0}
    for rid, slots in acc.items():
        tot = {k: slots.get(k, [0.0, 0.0]) for k in keys}
        v = {k: tot[k][0] + tot[k][1] for k in keys}
        shaping = v["shape_s"]
        wire = max(0.0, v["send_block_s"] - shaping)
        row = {
            "wire_s": round(wire, 4),
            "stall_s": round(v["recv_wait_s"], 4),
            "combine_s": round(v["combine_s"], 4),
            "shaping_s": round(shaping, 4),
            "hops": int(v["hops"]),
        }
        denom = wire + v["recv_wait_s"] + v["combine_s"] + shaping
        row["fractions"] = {
            k: (round(row[k] / denom, 4) if denom > 0 else None)
            for k in ("wire_s", "stall_s", "combine_s", "shaping_s")
        }
        per_replica[rid] = row
        for k in totals:
            totals[k] += row[k]
    denom = sum(totals.values())
    return {
        "per_replica": dict(sorted(per_replica.items())),
        "totals": {k: round(v, 4) for k, v in totals.items()},
        "fractions": {
            k: (round(v / denom, 4) if denom > 0 else None)
            for k, v in totals.items()
        },
    }


def election_windows(events: Sequence[dict]) -> List[Tuple[float, float]]:
    """[(start_ts, end_ts)] of lighthouse leader elections in the stream:
    from a scripted lighthouse fault (``fault`` kind="lighthouse") to the
    next standby takeover (``lighthouse_failover``, emitted by
    torchft_tpu/ha/replica.py with the new leader epoch).  A fault with no
    subsequent takeover yields no window (the election never resolved —
    nothing to bound)."""
    starts = sorted(
        float(ev["ts"])
        for ev in events
        if ev.get("event") == "fault" and str(ev.get("kind")) == "lighthouse"
    )
    takeovers = sorted(
        float(ev["ts"]) for ev in events if ev.get("event") == "lighthouse_failover"
    )
    windows: List[Tuple[float, float]] = []
    for s in starts:
        ends = [t for t in takeovers if t >= s]
        if ends:
            windows.append((s, ends[0]))
    return windows


def _fault_records(events: Sequence[dict]) -> List[dict]:
    return [ev for ev in events if ev.get("event") == "fault"]


def deadwindow(
    commits: Dict[str, List[float]], kills: Sequence[Tuple[float, str]]
) -> dict:
    """Dead-window goodput accounting (the benchmark headline).

    Over the window [t0, t_end] — t0 = the first moment EVERY group has
    committed (startup JIT excluded), t_end = the last commit — each
    killed group's commit gaps that contain >= 1 kill are charged as dead
    time, minus one median step interval (the step it would have taken
    anyway), and goodput = 1 - dead/span.  Insensitive to host-load rate
    drift, handles single/double/during-heal kills identically
    (overlapping kills land in one longer gap).

    Returns dead_time_s/fraction None (victims_recovered False) when a
    killed group never commits after its last kill — that trial measured
    an unrecovered victim, not goodput.
    """
    if not commits:
        return {
            "t0": None, "t_end": None, "span_s": None, "dead_time_s": None,
            "fraction": None, "victims_recovered": False,
        }
    t0 = max(min(ts_list) for ts_list in commits.values())
    t_end = max(max(ts_list) for ts_list in commits.values())
    span = t_end - t0
    dead_total = 0.0
    victims_recovered = True
    for g in {grp for _, grp in kills}:
        g_kills = sorted(ts for ts, grp in kills if grp == g)
        cs = sorted(commits.get(g, []))
        if not cs or max(cs) < max(g_kills):
            victims_recovered = False  # never committed after its kill
            continue
        steps_iv = [b - a for a, b in zip(cs, cs[1:])]
        med = sorted(steps_iv)[len(steps_iv) // 2] if steps_iv else 0.0
        for a, b in zip(cs, cs[1:]):
            if any(a <= k < b for k in g_kills):
                dead_total += max(0.0, (b - a) - med)
    fraction = None
    if kills and span > 0 and victims_recovered:
        fraction = max(0.0, 1.0 - dead_total / span)
    return {
        "t0": t0,
        "t_end": t_end,
        "span_s": span,
        "dead_time_s": dead_total if kills else None,
        "fraction": fraction,
        "victims_recovered": victims_recovered if kills else True,
    }


# ---------------------------------------------------------------------------
# Per-step attribution
# ---------------------------------------------------------------------------

# Phases that run on background threads CONCURRENT with the train step
# (torchft_tpu/obs/spans.py OVERLAPPED_PHASES): the donor-side async
# snapshot flatten and the semisync engine's background fragment rounds
# (outer_sync).  They are reported (snapshot_overlap_s sums all of them)
# but never charged against productive wall time — subtracting an
# overlapped span from the step interval would fabricate FT cost that the
# async pipeline specifically does not impose.
#
# NOT in this tuple: ``allreduce_d2h`` / ``allreduce_h2d``, the
# GradientAverager's per-bucket device->host fetch and the result
# scatter-back.  Both block the train thread (the pipeline overlaps
# bucket k's WIRE time with bucket k+1's copy, but the copy wait itself is
# serial with compute), so they fall through the generic branch below into
# ``other_ft`` — FT overhead, never productive.  Moving either here would
# inflate productive time by exactly the transfer stall and break the
# dead-window math bench.py reproduces from these streams.
# Aliased from the one registry (obs/spans.py), not duplicated: a phase
# added to OVERLAPPED_PHASES but missed here would be charged against
# productive wall time — fabricated FT cost.
_OVERLAPPED = OVERLAPPED_PHASES

# Phase ms a legacy (pre-span) stream carries on its lifecycle events,
# mapped onto span phase names so old recordings still attribute.
_LEGACY_MS = {
    "quorum": ("quorum", "quorum_ms"),
    "reconfigure": ("configure", "configure_ms"),
    "heal_fetched": ("heal", "heal_ms"),
    "commit": ("commit_vote", "vote_ms"),
}


def _phase_ms(events: Sequence[dict]) -> Dict[Tuple[str, int], Dict[str, float]]:
    """{(replica_id, step): {phase: ms}} from span records, falling back to
    the legacy *_ms fields when a stream predates spans.  step_summary is
    authoritative when present (it is the flushed accumulation)."""
    spans: Dict[Tuple[str, int], Dict[str, float]] = {}
    summarized: set = set()
    for ev in events:
        rid = str(ev.get("replica_id", ""))
        kind = ev.get("event")
        if kind == "step_summary" and isinstance(ev.get("phases"), dict):
            key = (rid, int(ev.get("step", -1)))
            if key in summarized:
                # A failed-then-retried commit vote summarizes the same step
                # twice; the committed interval's wall spans both attempts,
                # so their phases ADD (replacing would misattribute the
                # first attempt's waits as productive time).
                d = spans.setdefault(key, {})
                for k, v in ev["phases"].items():
                    d[k] = d.get(k, 0.0) + float(v)
            else:
                # First summary supersedes the raw spans already
                # accumulated for this key — they are the same
                # measurements, flushed.
                spans[key] = {k: float(v) for k, v in ev["phases"].items()}
                summarized.add(key)
        elif kind == "span":
            key = (rid, int(ev.get("step", -1)))
            if key in summarized:
                continue
            d = spans.setdefault(key, {})
            phase = str(ev.get("phase", "?"))
            d[phase] = d.get(phase, 0.0) + float(ev.get("duration_ms", 0.0))
        elif kind in _LEGACY_MS:
            phase, field = _LEGACY_MS[kind]
            if ev.get(field) is None:
                continue
            key = (rid, int(ev.get("step", ev.get("max_step", -1))))
            if key in summarized:
                continue
            d = spans.setdefault(key, {})
            # Spans supersede the legacy duplicates of the same phase: the
            # Manager emits both (span record + legacy event) from ONE
            # measurement, so take max instead of summing.
            d[phase] = max(d.get(phase, 0.0), float(ev[field]))
    return spans


def quorum_server_ms(
    events: Sequence[dict], flight_events: Sequence[dict]
) -> Dict[Tuple[str, int], float]:
    """``{(replica_id, step): server-side quorum ms}`` joining the worker
    span stream against a lighthouse flight recorder by causal trace id.

    The worker's ``quorum`` span measures the CLIENT-observed wait (RPC
    transport, failover retries, the blocked server handler).  The flight
    recorder's ``rpc`` span for the same trace id measures the SERVER-side
    handling window (which contains the formation wait).  Their difference
    is client transport/retry cost — the split :func:`attribute` reports.
    Server spans for one trace id are summed across records (an HA
    failover records a rejection span on the old leader and the real span
    on the new one; both are real server-side time the client paid)."""
    server_ms: Dict[str, float] = {}
    for ev in flight_events:
        if ev.get("kind") != "rpc" or ev.get("method") != "Quorum":
            continue
        tid = str(ev.get("trace_id", ""))
        if not tid:
            continue
        server_ms[tid] = server_ms.get(tid, 0.0) + max(
            0.0, float(ev.get("dur_us", 0)) / 1e3
        )
    # Each (replica, step) sums its DISTINCT trace ids' server totals, not
    # one total per worker span: a retried commit re-runs the quorum with
    # the SAME step-keyed trace id and emits a second worker span — adding
    # server_ms per span would double the server share and zero out the
    # transport split on exactly the retried steps.
    tids_by_key: Dict[Tuple[str, int], set] = {}
    for ev in events:
        if ev.get("event") != "span" or ev.get("phase") != "quorum":
            continue
        tid = str(ev.get("trace_id", ""))
        if tid in server_ms:
            key = (str(ev.get("replica_id", "")), int(ev.get("step", -1)))
            tids_by_key.setdefault(key, set()).add(tid)
    return {
        key: sum(server_ms[tid] for tid in tids)
        for key, tids in tids_by_key.items()
    }


def attribute(
    events: Sequence[dict], flight_events: Optional[Sequence[dict]] = None
) -> dict:
    """Builds the per-step cluster attribution.

    Returns ``{"steps": [row...], "totals": {...}, "goodput": {...}}``.
    Each row: ``step``, ``replicas`` (committing that step), ``wall_s``
    (slowest replica's commit-to-commit interval), per-phase seconds of
    that slowest replica, ``productive_s`` (wall minus FT phases) and
    ``critical`` — the dominating bucket.

    Totals classify every group's [t0, t_end] wall time into productive /
    quorum_wait / heal / drain / idle: step intervals split by their phase
    breakdown; gaps between incarnations (or commit gaps containing a
    fault) are idle, or drain when a drain fault falls inside.

    With ``flight_events`` (a lighthouse flight-recorder dump's events,
    see obs/flight.py), quorum_wait_s is additionally split into
    ``quorum_server_s`` (the lighthouse's own formation/handling window,
    matched by causal trace id) and ``quorum_transport_s`` (client
    transport + failover retries) — informational sub-buckets, not new
    accounting classes.
    """
    commits = commit_timelines(events)
    faults = fault_times(events)
    dw = deadwindow(commits, faults)
    phase_ms = _phase_ms(events)
    elections = election_windows(events)
    server_q_ms = (
        quorum_server_ms(events, flight_events) if flight_events else {}
    )

    # Per-incarnation commit sequences: (rid, [(ts, t_mono, step)...]).
    per_inc: Dict[str, List[Tuple[float, float, int]]] = {}
    for ev in events:
        if ev.get("event") == "commit" and ev.get("committed"):
            per_inc.setdefault(str(ev.get("replica_id", "")), []).append(
                (
                    float(ev["ts"]),
                    float(ev.get("t_mono", ev["ts"])),
                    int(ev.get("step", -1)),
                )
            )

    steps: Dict[int, List[dict]] = {}
    totals = {
        "productive_s": 0.0,
        "quorum_wait_s": 0.0,
        "heal_s": 0.0,
        "other_ft_s": 0.0,
        "drain_s": 0.0,
        "idle_s": 0.0,
        # Informational: background snapshot time OVERLAPPED with the steps
        # above — deliberately outside the accounted classification.
        "snapshot_overlap_s": 0.0,
        # Informational: leader-election time inside step intervals.  Its
        # charge flows through quorum_wait_s (an election stalls exactly
        # the quorum path, so it is classified as quorum wait, NOT as a
        # worker fault's idle time) — this total just makes the election
        # cost visible on its own line.
        "election_s": 0.0,
        # Informational split of quorum_wait_s when a flight recorder was
        # provided: server-side formation/handling vs client transport and
        # retries.  Zero (not the split) without flight data.
        "quorum_server_s": 0.0,
        "quorum_transport_s": 0.0,
    }
    t0 = dw["t0"]
    for rid, seq in per_inc.items():
        seq.sort()
        for (ts_a, mono_a, _), (ts_b, mono_b, step) in zip(seq, seq[1:]):
            if t0 is not None and ts_b < t0:
                continue  # startup, outside the measured window
            # Same process: monotonic delta is the trustworthy duration.
            wall = max(0.0, mono_b - mono_a)
            phases = phase_ms.get((rid, step), {})
            q = phases.get("quorum", 0.0) / 1e3
            # Leader-election overlap with this interval is charged like
            # quorum wait: the quorum span usually measures the stall
            # already (the blocked quorum RPC IS the election wait), so the
            # election window acts as a FLOOR on q rather than adding to
            # it — never double-charged, never read as productive time.
            election = sum(
                max(0.0, min(ts_b, e) - max(ts_a, s)) for s, e in elections
            )
            election = min(election, wall)
            if election > q:
                q = election
            # ec_reconstruct is healing by another path (the donor-free
            # shard fallback) — same class, so a cluster that heals via
            # reconstruction reads comparably to one that heals via donors.
            heal = (
                phases.get("heal", 0.0) + phases.get("ec_reconstruct", 0.0)
            ) / 1e3
            skip = ("quorum", "heal", "ec_reconstruct") + _OVERLAPPED
            other_ft = (
                sum(v for k, v in phases.items() if k not in skip) / 1e3
            )
            snapshot_overlap = (
                sum(phases.get(k, 0.0) for k in _OVERLAPPED) / 1e3
            )
            # Flight-recorder split of the quorum wait: the server-side
            # window (clamped to q — clock granularity can make the server
            # span read microseconds past the client wait) vs the client's
            # transport/retry remainder.  Only meaningful when the span's
            # trace id matched a recorded server span.
            q_server = min(q, server_q_ms.get((rid, step), 0.0) / 1e3)
            q_transport = q - q_server if (rid, step) in server_q_ms else 0.0
            productive = max(0.0, wall - q - heal - other_ft)
            buckets = {
                "productive": productive,
                "quorum_wait": q,
                "heal": heal,
                **{k: v / 1e3 for k, v in phases.items() if k not in skip},
            }
            critical = max(buckets, key=lambda k: buckets[k]) if wall > 0 else "-"
            steps.setdefault(step, []).append(
                {
                    "replica_id": rid,
                    "wall_s": wall,
                    "quorum_wait_s": q,
                    "quorum_server_s": q_server,
                    "quorum_transport_s": q_transport,
                    "heal_s": heal,
                    "other_ft_s": other_ft,
                    "snapshot_overlap_s": snapshot_overlap,
                    "productive_s": productive,
                    "critical": critical,
                }
            )
            totals["productive_s"] += productive
            totals["quorum_wait_s"] += q
            totals["quorum_server_s"] += q_server
            totals["quorum_transport_s"] += q_transport
            totals["heal_s"] += heal
            totals["other_ft_s"] += other_ft
            totals["snapshot_overlap_s"] += snapshot_overlap
            totals["election_s"] += election

    # A restarted incarnation's heal span lies BEFORE its first commit, so
    # no commit interval covers it; credit it to the heal class (carved
    # out of that group's gap below) instead of leaving it in idle.
    first_commit_heal: Dict[str, float] = {}
    for rid, seq in per_inc.items():
        if not seq:
            continue
        ts_first, _, step_first = seq[0]
        if t0 is not None and ts_first >= t0:
            first_phases = phase_ms.get((rid, step_first), {})
            h = (
                first_phases.get("heal", 0.0)
                + first_phases.get("ec_reconstruct", 0.0)
            ) / 1e3
            if h:
                g = _group(rid)
                first_commit_heal[g] = first_commit_heal.get(g, 0.0) + h

    # Idle / drain: per group, wall time in [t0, t_end] not covered by
    # intra-incarnation step intervals — restart windows and fault gaps.
    # A gap belonging to a group whose only faults were drains is planned
    # departure cost ("drain"); everything else is dead time ("idle").
    if t0 is not None:
        drain_groups = {
            str(ev.get("group", ""))
            for ev in _fault_records(events)
            if str(ev.get("kind")) == "drain"
        }
        kill_groups = {
            str(ev.get("group", ""))
            for ev in _fault_records(events)
            if str(ev.get("kind")) not in ("drain", "straggler")
        }
        for g, ts_list in commits.items():
            covered = 0.0
            for rid, seq in per_inc.items():
                if _group(rid) != g:
                    continue
                for (ts_a, _, _), (ts_b, _, _) in zip(seq, seq[1:]):
                    a = max(ts_a, t0)
                    if ts_b > a:
                        covered += ts_b - a
            group_span = max(0.0, dw["t_end"] - max(t0, min(ts_list)))
            gap = max(0.0, group_span - covered)
            heal_in_gap = min(gap, first_commit_heal.get(g, 0.0))
            totals["heal_s"] += heal_in_gap
            gap -= heal_in_gap
            if g in drain_groups and g not in kill_groups:
                totals["drain_s"] += gap
            else:
                totals["idle_s"] += gap

    rows = []
    for step in sorted(steps):
        reps = steps[step]
        slowest = max(reps, key=lambda r: r["wall_s"])
        rows.append(
            {
                "step": step,
                "replicas": len(reps),
                "wall_s": round(slowest["wall_s"], 4),
                "productive_s": round(slowest["productive_s"], 4),
                "quorum_wait_s": round(slowest["quorum_wait_s"], 4),
                "quorum_server_s": round(slowest["quorum_server_s"], 4),
                "quorum_transport_s": round(slowest["quorum_transport_s"], 4),
                "heal_s": round(slowest["heal_s"], 4),
                "other_ft_s": round(slowest["other_ft_s"], 4),
                "snapshot_overlap_s": round(slowest["snapshot_overlap_s"], 4),
                "critical": slowest["critical"],
            }
        )

    accounted = sum(
        totals[k] for k in
        ("productive_s", "quorum_wait_s", "heal_s", "drain_s", "idle_s",
         "other_ft_s")
    )
    fractions = {
        k.replace("_s", "_fraction"): (round(v / accounted, 4) if accounted else None)
        for k, v in totals.items()
    }
    return {
        "steps": rows,
        "totals": {k: round(v, 3) for k, v in totals.items()},
        "fractions": fractions,
        # Byte-level rollup (payload + per-tier wire), comparable across
        # ring/ring2d topologies — not a time-accounting class.
        "data_plane": data_plane(events),
        # Hop-level wall attribution of the allreduce path (wire / stall /
        # combine / shaping) from the ring engines' hop telemetry.
        "link_attribution": link_attribution(events),
        # Per-step goodput-ledger rollup (obs/ledger.py): the cause
        # vectors each committed step_summary carries, summed per replica
        # and cluster-wide — the stream-side mirror of the lighthouse's
        # live /goodput.json.
        "ledger": _ledger_rollup(events),
        "goodput": {
            "deadwindow_fraction": (
                round(dw["fraction"], 4) if dw["fraction"] is not None else None
            ),
            "dead_time_s": (
                round(dw["dead_time_s"], 3) if dw["dead_time_s"] is not None else None
            ),
            "span_s": round(dw["span_s"], 3) if dw["span_s"] is not None else None,
            "victims_recovered": dw["victims_recovered"],
            "faults": len(faults),
            # Control-plane fault visibility: resolved leader elections in
            # the stream (their time is in totals.election_s, charged as
            # quorum wait — never as a worker dead window).
            "lighthouse_elections": len(elections),
        },
    }


def render(result: dict, out=sys.stdout) -> None:
    """Human-readable attribution table + goodput summary."""
    w = out.write
    w(
        f"{'step':>6} {'reps':>4} {'wall_s':>8} {'product':>8} "
        f"{'quorum':>8} {'heal':>8} {'other_ft':>8}  critical\n"
    )
    for r in result["steps"]:
        w(
            f"{r['step']:>6} {r['replicas']:>4} {r['wall_s']:>8.3f} "
            f"{r['productive_s']:>8.3f} {r['quorum_wait_s']:>8.3f} "
            f"{r['heal_s']:>8.3f} {r['other_ft_s']:>8.3f}  {r['critical']}\n"
        )
    t = result["totals"]
    w("\ntotals (s): " + "  ".join(f"{k}={v}" for k, v in t.items()) + "\n")
    f = result["fractions"]
    w("fractions:  " + "  ".join(f"{k}={v}" for k, v in f.items()) + "\n")
    g = result["goodput"]
    w(
        f"\ngoodput (dead-window): fraction={g['deadwindow_fraction']} "
        f"dead_time_s={g['dead_time_s']} span_s={g['span_s']} "
        f"faults={g['faults']} victims_recovered={g['victims_recovered']}\n"
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchft_tpu_torch.obs.report",
        description="Per-step goodput attribution from tpu-ft metrics JSONL",
    )
    ap.add_argument("paths", nargs="+", help="metrics.jsonl file(s)")
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument(
        "--flight",
        action="append",
        default=[],
        metavar="FLIGHT_JSON",
        help="flight-recorder dump(s) (flight_lighthouse_*.json) — splits "
        "quorum_wait into server-formation vs client-transport by trace id",
    )
    args = ap.parse_args(argv)
    stats: dict = {}
    events = read_events(args.paths, stats=stats)
    if not events:
        print("no events parsed", file=sys.stderr)
        return 1
    flight: list = []
    unreadable_flight: list = []
    for fp in args.flight:
        try:
            from torchft_tpu_torch.obs.flight import flight_events as _fes
            from torchft_tpu_torch.obs.flight import load_flight_dump

            flight.extend(_fes(load_flight_dump(fp)))
        except (OSError, ValueError):
            unreadable_flight.append(fp)
            print(f"warning: {fp}: unreadable flight dump", file=sys.stderr)
    result = attribute(events, flight_events=flight or None)
    result["input"] = {
        "events": len(events),
        "skipped_lines": stats.get("skipped_lines", 0),
        "unreadable_files": stats.get("unreadable_files", []),
        "flight_events": len(flight),
        "unreadable_flight_dumps": unreadable_flight,
    }
    if args.json:
        json.dump(result, sys.stdout)
        print()
    else:
        render(result)
        if stats.get("skipped_lines"):
            sys.stdout.write(
                f"\n({stats['skipped_lines']} unparseable line(s) skipped)\n"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
