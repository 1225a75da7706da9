"""Control-plane flight recorder: Python-side registry, trace ids, and
dump analysis.

The port's own copy of ``torchft_tpu/obs/flight.py``: the same record and
field names, registries, environment knobs and defaults, so either
package's consumers read either package's streams (held against the
JAX package's by tests/test_torch_obs.py).  Paths named below are the
JAX package's where the port has no counterpart.

The native Lighthouse and ManagerServer each keep a bounded in-memory ring
of control-plane events — server-side RPC spans plus state transitions
(quorum formed/changed, replica join/evict/drain, sentinel hysteresis
moves, HA role changes) — implemented in ``native/src/flight.h``.  Read it
live via ``GET /debug/flight.json`` (lighthouse), the
``LighthouseServer.flight()`` / ``ManagerServer.flight()`` accessors, or
the JSON file every server dumps into ``$TPUFT_FLIGHT_DIR`` on shutdown
(``flight_lighthouse_<port>.json`` / ``flight_manager_<id>.json``).

This module is the matching consumer layer:

- :data:`FLIGHT_EVENTS` — the registry of every event kind the native
  recorders may emit, grep-pinned against the ``kFlight*`` constants in
  ``native/src/flight.h`` by ``tests/test_flight.py`` (the same discipline
  as ``torchft_tpu.metrics.EVENTS``);
- :func:`mint_trace_id` / :func:`parse_trace_id` — the causal trace id the
  Manager mints once per step and every control RPC carries, Dapper-style,
  so one step's path can be followed across processes;
- :func:`load_flight_dump` / :func:`flight_events` /
  :func:`quorum_transitions` — post-mortem reconstruction of the
  quorum-transition sequence around a fault from the dump alone;
- :func:`flight_to_stream` — converts a dump into metrics-stream-shaped
  events (``cp_rpc`` / ``cp_event``) that ``obs/trace.py`` renders as a
  control-plane track next to the worker tracks.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "FLIGHT_EVENTS",
    "mint_trace_id",
    "parse_trace_id",
    "load_flight_dump",
    "flight_events",
    "quorum_transitions",
    "flight_to_stream",
]

# Registry of every flight-recorder event kind the native servers emit:
# kind -> one-line meaning.  Must stay in exact sync with the kFlight*
# constants in native/src/flight.h (tests/test_flight.py greps both sides).
FLIGHT_EVENTS = {
    "rpc": "server-side RPC span: method, peer, status, recv->send µs, "
           "trace id — recorded for every handled frame, including "
           "rejections",
    "quorum_formed": "a quorum with CHANGED membership formed "
                     "(quorum_id, members, joined/left delta, formation "
                     "latency); steady-state identical formations are not "
                     "recorded so the ring retains transitions",
    "replica_join": "first quorum join from an incarnation the lighthouse "
                    "had no heartbeat for",
    "replica_evict": "supervisor-assisted eviction dropped matching ids",
    "replica_drain": "cooperative-drain mark placed on matching ids",
    "sentinel_transition": "straggler-sentinel hysteresis state change "
                           "(healthy/suspect/straggler) for one replica",
    "role_change": "HA role flip (leader/follower) with the lease epoch",
    "quorum_result": "manager-side outcome of one aggregated lighthouse "
                     "quorum round (quorum id + size, or failure status)",
    "incident": "incident-capture trigger recorded (reason, replica, step, "
                "detail) — mirrored on GET /incident.json for the capture "
                "driver (obs/incident.py)",
    "shutdown": "server shutting down cleanly (the dump-to-file marker)",
}


def mint_trace_id(slice_gen: int, replica_id: str, step: int) -> str:
    """Causal trace id for one step of one incarnation:
    ``"<slice_gen>/<replica_id>#<step>"``.  The Manager mints one per
    quorum round; the id is an opaque correlation key everywhere else
    (servers record it, never parse it)."""
    return f"{int(slice_gen)}/{replica_id}#{int(step)}"


def parse_trace_id(trace_id: str) -> Optional[Tuple[int, str, int]]:
    """Inverse of :func:`mint_trace_id`; None when ``trace_id`` does not
    look like one (foreign ids pass through the system unharmed)."""
    try:
        gen_s, rest = str(trace_id).split("/", 1)
        rid, step_s = rest.rsplit("#", 1)
        return int(gen_s), rid, int(step_s)
    except (ValueError, AttributeError):
        return None


def load_flight_dump(path: str) -> dict:
    """Reads one flight dump (``flight_*.json``).  Raises on unreadable or
    structurally foreign files — a kill-bench trial asserts the dump both
    exists and parses, so errors must surface."""
    with open(path, "r", encoding="utf-8") as f:
        dump = json.load(f)
    if not isinstance(dump, dict) or not isinstance(dump.get("events"), list):
        raise ValueError(f"{path}: not a flight-recorder dump")
    return dump


def flight_events(dump: dict) -> List[dict]:
    """The dump's events OLDEST-first (the wire/dump order is newest-first;
    analysis reads forward in time)."""
    events = [ev for ev in dump.get("events", []) if isinstance(ev, dict)]
    return sorted(events, key=lambda ev: ev.get("seq", 0))


_LIST_RE = re.compile(r"^\[(.*)\]$")


def _parse_detail(detail: str) -> Dict[str, object]:
    """Parses the native recorder's ``k=v k=[a,b]`` detail tokens into a
    dict (lists split on commas, numbers converted when clean)."""
    out: Dict[str, object] = {}
    for token in str(detail or "").split():
        if "=" not in token:
            continue
        k, v = token.split("=", 1)
        m = _LIST_RE.match(v)
        if m:
            out[k] = [x for x in m.group(1).split(",") if x]
            continue
        try:
            out[k] = int(v)
        except ValueError:
            try:
                out[k] = float(v)
            except ValueError:
                out[k] = v
    return out


def quorum_transitions(events: Sequence[dict]) -> List[dict]:
    """Reconstructs the quorum-transition sequence from flight events
    (oldest-first): one row per ``quorum_formed`` event with parsed
    ``quorum_id`` / ``members`` / ``joined`` / ``left`` /
    ``formation_ms`` / ``ts_ms``.  This is the post-mortem a kill-bench
    dump must support: who left at the kill, when the shrunken quorum
    formed, and when the restarted incarnation rejoined."""
    out: List[dict] = []
    for ev in events:
        if ev.get("kind") != "quorum_formed":
            continue
        d = _parse_detail(ev.get("detail", ""))
        out.append(
            {
                "ts_ms": ev.get("ts_ms", 0),
                "seq": ev.get("seq", 0),
                "quorum_id": d.get("quorum_id"),
                "members": d.get("members", []),
                "joined": d.get("joined", []),
                "left": d.get("left", []),
                "formation_ms": d.get("formation_ms", 0.0),
            }
        )
    return out


def flight_to_stream(dump: dict, source: Optional[str] = None) -> List[dict]:
    """Converts a flight dump into metrics-stream-shaped events for the
    Perfetto export (obs/trace.py):

    - each RPC span becomes a ``cp_rpc`` record (``ts`` = wall END time in
      seconds, ``duration_ms``, ``method``, ``status``, ``peer``,
      ``trace_id``);
    - each state event becomes a ``cp_event`` instant (kind + parsed
      detail fields).

    ``source`` labels the track ("lighthouse:8080"); defaults to the
    dump's own server/id identity.  Timestamps are the server's wall
    clock — on the export timeline they sit in the same frame the worker
    clock-alignment normalizes to (the cross-replica median), which on one
    host is the shared system clock.
    """
    if source is None:
        server = str(dump.get("server", "server"))
        ident = str(dump.get("id", ""))
        source = f"{server}:{ident}" if ident else server
    out: List[dict] = []
    for ev in flight_events(dump):
        ts = float(ev.get("ts_ms", 0)) / 1e3
        if ev.get("kind") == "rpc":
            out.append(
                {
                    "event": "cp_rpc",
                    "source": source,
                    "ts": ts,
                    "method": str(ev.get("method", "?")),
                    "status": int(ev.get("status", 0)),
                    "peer": ev.get("peer", ""),
                    "trace_id": ev.get("trace_id", ""),
                    "duration_ms": max(0.0, float(ev.get("dur_us", 0)) / 1e3),
                }
            )
        else:
            rec = {
                "event": "cp_event",
                "source": source,
                "ts": ts,
                "kind": str(ev.get("kind", "?")),
                "trace_id": ev.get("trace_id", ""),
            }
            rec.update(
                {
                    f"d_{k}": v
                    for k, v in _parse_detail(ev.get("detail", "")).items()
                }
            )
            out.append(rec)
    return out
