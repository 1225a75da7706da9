"""Structured per-step metrics: JSONL event stream from the FT runtime.

The port's own copy of ``torchft_tpu/metrics.py``: the same record and
field names, registries, environment knobs and defaults, so either
package's consumers read either package's streams (held against the
JAX package's by tests/test_torch_obs.py).  Paths named below are the
JAX package's where the port has no counterpart.

The reference's observability is logs + the Lighthouse dashboard (SURVEY.md
§5 — no Prometheus/TensorBoard); this adds a machine-readable layer: when
``TPUFT_METRICS_PATH`` is set (or a path is passed explicitly), the Manager
appends one JSON object per lifecycle event — quorum formed, heal started,
commit decided, error latched — so goodput/recovery analyses read an event
stream instead of grepping log strings (the failure mode VERDICT r2 #6
flagged in the kill benchmark).

Format: one JSON object per line, always containing ``schema`` (record
schema version, currently 1), ``ts`` (unix seconds), ``t_mono`` (monotonic
seconds — duration math in tools/report must use this so it survives NTP
steps mid-run; ``ts`` is for humans and cross-host alignment only),
``replica_id`` and ``event``; remaining keys are event-specific.  Writes are
append-only, lock-serialized, and never raise into the train loop — metrics
must not be able to fail a step.

Every event name the runtime emits is declared in :data:`EVENTS`; emitting
an unregistered name still writes the record but flags it
``unregistered: true`` so consumers (obs/report.py) can surface schema
drift instead of silently ignoring unknown data.  A static test
(tests/test_obs.py) greps the ``emit(`` call sites against the registry so
new events cannot ship undocumented.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional

__all__ = ["MetricsLogger", "METRICS_PATH_ENV", "EVENTS", "SCHEMA_VERSION"]

METRICS_PATH_ENV = "TPUFT_METRICS_PATH"

# Version of the record layout (the always-present keys above).  Bump when
# a required key changes meaning; event-specific keys may grow freely.
SCHEMA_VERSION = 1

# Registry of every event name the runtime emits: name -> one-line meaning.
# obs/report.py keys its attribution off these; the static check in
# tests/test_obs.py fails if an emit() call site names an event that is not
# here.
EVENTS = {
    # -- Manager step lifecycle (torchft_tpu/manager.py) --------------------
    "quorum": "quorum result for a step (membership, participation, quorum_ms)",
    "reconfigure": "cross-group collective rebuilt for a new quorum id "
                   "(mode=full|incremental, reused/opened lane counts)",
    "membership_change": "participant set changed across a quorum "
                         "transition (old/new participant replica ranks, "
                         "joined/left delta, transition_s wall time, "
                         "configure mode, elastic plan when the elastic "
                         "batch engine is on) — what the elastic bench and "
                         "the incident verdict read to attribute resize "
                         "cost",
    "heal_start": "this replica began fetching weights from its donors "
                  "(n_donors = striped multi-donor fan-in)",
    "heal_fetched": "healed state dict received (heal_ms = fetch duration, "
                    "n_donors = donors actually striped across)",
    "error": "an error was latched for the current step",
    "commit": "two-phase commit vote decided (committed, vote_ms)",
    # -- spans (torchft_tpu/obs/spans.py) -----------------------------------
    "span": "begin/end-measured phase of one step (phase, duration_ms)",
    "step_summary": "per-step phase breakdown emitted after the commit vote",
    # -- cooperative drain (torchft_tpu/drain, manager.py, launch.py) -------
    "drain_notice": "drain notice received; finishing the in-flight step",
    "drain_complete": "cooperative departure finished cleanly",
    "drain_handoff": "launcher handed the draining group's id to a spare",
    "drain_donor_exit": "draining donor process exited",
    # -- straggler sentinel (native lighthouse + launch.py, bench.py) -------
    "straggler_injected": "bench driver began the per-step sleep injection "
                          "on the victim group (sleep_s, pid-pinned)",
    "alert": "bench driver observed a sentinel alert on the lighthouse's "
             "/alerts.json (alert_id, ratio, raised_ms) — stamps detection "
             "into the stream so trace export and latency accounting see it",
    "straggler_drain": "launcher sentinel rotated a confirmed straggler out "
                       "through the cooperative-drain path",
    # -- slow-link sentinel (native lighthouse + bench_allreduce.py) --------
    "link_shaped": "bench driver degraded one peer direction's modeled "
                   "link (mbps, rtt_ms, group=victim) — the data-plane "
                   "fault the slow-link sentinel must localize",
    "link_alert": "bench driver observed a slow_link alert on the "
                  "lighthouse's /alerts.json (alert_id, src_replica_id, "
                  "gbps, detection_rounds) — stamps detection into the "
                  "stream for trace export and latency accounting",
    # -- hop telemetry (ring engines, via hops_to_stream) -------------------
    "hop": "one recorded ring hop (tier, lane, tag, send_s, recv_s, "
           "comb_s, nbytes; ts = hop start) — the data-plane flight "
           "recorder's timeline unit, merged from hops_*.json dumps",
    # -- erasure-coded peer state (torchft_tpu/ec) --------------------------
    "ec_push": "one committed step's shard generation encoded + placed "
               "(k, m, encode_ms, held, pushed parity count, push_errors) "
               "— emitted from the background snapshotter, one per encode",
    "ec_reconstruct": "donor-free heal: max-step state reassembled from "
                      "surviving shard holders (shards_used, parity_used, "
                      "corrupt = shards excluded by checksum)",
    # -- streaming semi-sync (torchft_tpu/semisync) -------------------------
    "semisync_round": "one outer DiLoCo round finished (committed, "
                      "fragments, wire_bytes, codec, residual_l2) — the "
                      "per-round accounting of the background fragment "
                      "sync plane",
    # -- HA lighthouse (torchft_tpu/ha/replica.py) --------------------------
    "lighthouse_failover": "a standby lighthouse took over leadership "
                           "(leader_epoch = the new lease epoch); "
                           "obs/report.py charges the election window like "
                           "quorum wait, not like a worker fault",
    # -- fault injection (bench.py) -----------------------------------------
    "fault": "scripted fault fired (kind=kill|drain|straggler|lighthouse, "
             "group=victim) — written by the benchmark driver so "
             "obs/report.py sees the same fault timeline the goodput "
             "accounting charges",
    # -- incident auto-capture (obs/incident.py, benchmark harnesses) -------
    "incident_captured": "an incident trigger on the lighthouse's "
                         "/incident.json was bundled into incident_<step>/ "
                         "(reason, incident_replica, bundle) — stamps the "
                         "capture into the stream next to the fault it "
                         "explains",
}


class MetricsLogger:
    """Append-only JSONL event writer; disabled (no-op) without a path."""

    def __init__(self, path: Optional[str], replica_id: str = "") -> None:
        self._path = path
        self._replica_id = replica_id
        self._lock = threading.Lock()
        self._file = None
        if path:
            try:
                # Unbuffered binary append: each record reaches the kernel as
                # ONE write() call, so O_APPEND keeps whole lines atomic even
                # with several processes sharing the file (stdio line
                # buffering splits lines longer than ~8KB mid-record).
                self._file = open(path, "ab", buffering=0)
            except OSError:
                self._file = None  # metrics must never break training

    @classmethod
    def from_env(cls, replica_id: str = "") -> "MetricsLogger":
        return cls(os.environ.get(METRICS_PATH_ENV), replica_id)

    @property
    def enabled(self) -> bool:
        return self._file is not None

    def emit(self, event: str, **fields: Any) -> None:
        if self._file is None:
            return
        record = {
            "schema": SCHEMA_VERSION,
            "ts": time.time(),
            "t_mono": time.monotonic(),
            "replica_id": self._replica_id,
            "event": event,
        }
        if event not in EVENTS:
            record["unregistered"] = True
        record.update(fields)
        try:
            line = (json.dumps(record, default=str) + "\n").encode()
            with self._lock:
                # Raw FileIO.write may return a short count without raising
                # (signal mid-write, near-full disk).  Finish the line: a
                # record with no trailing newline corrupts the NEXT record
                # too.  The continuation write can interleave with another
                # process in the (rare) short-write case — one torn record
                # beats two.
                view = memoryview(line)
                while view:
                    n = self._file.write(view)
                    if not n:
                        break
                    view = view[n:]
        except Exception:  # noqa: BLE001 — see module docstring
            pass

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                finally:
                    self._file = None
