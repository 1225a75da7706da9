"""Prometheus-style exposition for the semi-sync plane: ``tpuft_semisync_*``.

The counterpart of ``torchft_tpu/semisync/metrics.py``: a
:class:`SemiSyncMetrics` accumulates the engine's counters,
``render_prometheus`` produces the exposition, and ``serve`` (opt-in:
``TPUFT_SEMISYNC_METRICS_PORT``) publishes it at ``/metrics`` on the
port's shared text-exposition server (``torchft_tpu_torch/http.py``).
Counters are monotonic since construction; gauges hold the last
observation.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

__all__ = [
    "SemiSyncMetrics",
    "TPUFT_SEMISYNC_METRICS_PORT_ENV",
    "TPUFT_SEMISYNC_METRICS_BIND_ENV",
]

TPUFT_SEMISYNC_METRICS_PORT_ENV = "TPUFT_SEMISYNC_METRICS_PORT"
TPUFT_SEMISYNC_METRICS_BIND_ENV = "TPUFT_SEMISYNC_METRICS_BIND"

# (name, kind, help, attribute), in exposition order.
_METRICS = (
    ("tpuft_semisync_fragments_total", "counter",
     "fragment pseudogradient rounds completed", "fragments_total"),
    ("tpuft_semisync_rounds_total", "counter",
     "outer sync rounds finished (committed + aborted)", "rounds_total"),
    ("tpuft_semisync_commits_total", "counter",
     "outer sync rounds that passed the commit vote", "commits_total"),
    ("tpuft_semisync_aborts_total", "counter",
     "outer sync rounds discarded (error latched / vote lost)", "aborts_total"),
    ("tpuft_semisync_wire_bytes_total", "counter",
     "per-hop wire bytes of fragment payloads (codec-encoded)", "wire_bytes_total"),
    ("tpuft_semisync_d2h_bytes_total", "counter",
     "device->host fetch bytes of fragment payloads", "d2h_bytes_total"),
    ("tpuft_semisync_residual_l2", "gauge",
     "L2 norm of the carried int8 error-feedback residual", "last_residual_l2"),
    ("tpuft_semisync_round_overlap_ms", "gauge",
     "last round's background sync time overlapped with inner steps",
     "last_round_overlap_ms"),
)


class SemiSyncMetrics:
    """Thread-safe counters and gauges of one StreamingDiLoCo."""

    def __init__(self, codec: str = "", replica_id: str = "") -> None:
        self.codec = codec
        self.replica_id = replica_id
        self._lock = threading.Lock()
        self.fragments_total = 0
        self.rounds_total = 0
        self.commits_total = 0
        self.aborts_total = 0
        self.wire_bytes_total = 0
        self.d2h_bytes_total = 0
        self.last_residual_l2 = 0.0
        self.last_round_overlap_ms = 0.0
        self._server = None

    def observe_fragment(self, wire_bytes: int, d2h_bytes: int) -> None:
        with self._lock:
            self.fragments_total += 1
            self.wire_bytes_total += int(wire_bytes)
            self.d2h_bytes_total += int(d2h_bytes)

    def observe_round(self, committed: bool) -> None:
        with self._lock:
            self.rounds_total += 1
            if committed:
                self.commits_total += 1
            else:
                self.aborts_total += 1

    @property
    def serving(self) -> bool:
        """True while the HTTP exposition is up (so gauges nobody scrapes
        can be skipped)."""
        return self._server is not None

    def observe_residual(self, l2: float) -> None:
        with self._lock:
            self.last_residual_l2 = float(l2)

    def observe_overlap_ms(self, ms: float) -> None:
        with self._lock:
            self.last_round_overlap_ms = float(ms)

    def render_prometheus(self) -> str:
        """The ``tpuft_semisync_*`` exposition (Prometheus text format)."""
        with self._lock:
            parts = []
            if self.replica_id:
                parts.append(f'replica="{self.replica_id}"')
            if self.codec:
                parts.append(f'codec="{self.codec}"')
            label = "{" + ",".join(parts) + "}" if parts else ""
            lines = []
            for name, kind, help_, attr in _METRICS:
                lines += [f"# HELP {name} {help_}", f"# TYPE {name} {kind}",
                          f"{name}{label} {getattr(self, attr)}"]
            return "\n".join(lines) + "\n"

    def serve(self, port: Optional[int] = None, bind: Optional[str] = None) -> Optional[int]:
        """Serves ``GET /metrics`` on a daemon thread.  ``port=None`` reads
        ``TPUFT_SEMISYNC_METRICS_PORT`` (unset or empty: off; 0: any free
        port); ``bind=None`` reads ``TPUFT_SEMISYNC_METRICS_BIND``, default
        loopback (``::1``: the endpoint is unauthenticated).  Returns the
        bound port or None; never raises."""
        if port is None:
            raw = os.environ.get(TPUFT_SEMISYNC_METRICS_PORT_ENV, "")
            if not raw.strip():
                return None
            try:
                port = int(raw)
            except ValueError:
                return None
        if bind is None:
            bind = os.environ.get(TPUFT_SEMISYNC_METRICS_BIND_ENV, "").strip() or "::1"
        from torchft_tpu_torch.http import serve_text_exposition

        server = serve_text_exposition(self.render_prometheus, port, bind,
                                       thread_name="tpuft_semisync_metrics")
        if server is None:
            return None
        self._server = server
        return server.server_address[1]

    def close(self) -> None:
        server, self._server = self._server, None
        if server is not None:
            try:
                server.shutdown()
                server.server_close()
            except Exception:  # noqa: BLE001
                pass
