"""Observability: step-scoped tracing, goodput attribution, trace export,
the worker ``/metrics`` endpoint, incident capture and the watcher.

The port's copy of ``torchft_tpu/obs``:

- :mod:`torchft_tpu_torch.obs.spans` — the producer side: ``SpanTracker``
  wraps each Manager and averager phase in a span and emits one
  ``step_summary`` record a step; ``StepTimeStats`` keeps the busy-time
  EWMA the Manager pushes onto heartbeats.
- :mod:`torchft_tpu_torch.obs.ledger` — every committed step's wall time
  classified into the pinned cause taxonomy (``CAUSES``), pushed onto
  heartbeat fields 14-16.
- :mod:`torchft_tpu_torch.obs.flight` — trace ids and the native servers'
  flight-recorder dumps.
- :mod:`torchft_tpu_torch.obs.report` — the consumer: per-step phase
  attribution, dead-window goodput, data-plane rollups.  CLI::

      python -m torchft_tpu_torch.obs.report metrics.jsonl [...]

- :mod:`torchft_tpu_torch.obs.trace` — the same streams as one
  Chrome/Perfetto trace.  CLI::

      python -m torchft_tpu_torch.tools.trace_export metrics.jsonl [...]

- :mod:`torchft_tpu_torch.obs.prom` — ``WorkerMetrics``, one pull-based
  ``/metrics`` per worker (``TPUFT_WORKER_METRICS_PORT`` / ``_BIND``) the
  Manager serves, and the histogram helpers.
- :mod:`torchft_tpu_torch.obs.incident` — incident bundles from the
  lighthouse's ``/incident.json`` triggers, and their verdicts.  CLI::

      python -m torchft_tpu_torch.tools.incident capture|verdict ...

- :mod:`torchft_tpu_torch.obs.watcher` — the incident watcher: bundles,
  flap-guarded recommendations journaled to ``watcher_journal.jsonl``, a
  drain only when told to act.  CLI::

      python -m torchft_tpu_torch.obs.watcher --lighthouse <http address>
"""

from torchft_tpu_torch.obs.flight import FLIGHT_EVENTS, mint_trace_id
from torchft_tpu_torch.obs.ledger import CAUSES, LOST_CAUSES, StepLedger
from torchft_tpu_torch.obs.prom import WorkerMetrics
from torchft_tpu_torch.obs.spans import SpanTracker, StepTimeStats

__all__ = [
    "CAUSES",
    "FLIGHT_EVENTS",
    "LOST_CAUSES",
    "SpanTracker",
    "StepLedger",
    "StepTimeStats",
    "WorkerMetrics",
    "mint_trace_id",
]
