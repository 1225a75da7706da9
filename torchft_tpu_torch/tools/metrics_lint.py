"""Metrics lint: every metric family the port exports must be documented.

The counterpart of the JAX package's ``tools/metrics_lint.py``.  Boots a
bare native lighthouse (the port's ``_native.LighthouseServer``) and
renders a worker ``/metrics`` body through the port's
``obs/prom.WorkerMetrics`` with the Manager's own series provider and hop
histograms driven against a stub that reports one of everything, scrapes
both, extracts every ``# TYPE <family> <kind>`` declaration, and fails when
any family is missing from the documentation tables (``docs/wire.md`` and
``docs/observability.md``, searched as a union).

Exit codes: 0 clean, 1 undocumented families found, 2 scrape failure.

Run: ``python -m torchft_tpu_torch.tools.metrics_lint [--verbose]``.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import threading
import urllib.request
from types import SimpleNamespace

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_DOC_FILES = ("docs/wire.md", "docs/observability.md")


def _families(text: str) -> set:
    return set(re.findall(r"^# TYPE (\S+)", text, flags=re.M))


def lighthouse_families() -> set:
    """Scrape a bare native lighthouse.  Family declarations are printed
    even with empty label sets, so an idle instance exposes the full
    schema."""
    from torchft_tpu_torch._native import LighthouseServer

    lh = LighthouseServer(bind="127.0.0.1:0", min_replicas=1, join_timeout_ms=100,
                          quorum_tick_ms=50, heartbeat_timeout_ms=1000,
                          http_bind="127.0.0.1:0")
    try:
        with urllib.request.urlopen(lh.http_address() + "/metrics", timeout=5) as r:
            text = r.read().decode()
    finally:
        lh.shutdown()
    return _families(text)


def worker_families() -> set:
    """Render a worker /metrics body through the Manager's provider code
    (``Manager._worker_metrics_snapshot`` and ``_render_hop_histograms``)
    against a stub that reports one of everything, so every family the
    worker can export appears in the render."""
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.obs.ledger import LOST_CAUSES
    from torchft_tpu_torch.obs.prom import WorkerMetrics

    hops = {"hops": 1, "send_block_s": 0.1, "recv_wait_s": 0.1, "combine_s": 0.1,
            "shape_s": 0.1}
    fake = SimpleNamespace(
        _step=3,
        _step_stats=SimpleNamespace(snapshot=lambda: {"ewma": 120.0}),
        _ar_lock=threading.Lock(),
        _d2h_bytes_total=1024,
        _h2d_bytes_total=1024,
        _collective=SimpleNamespace(
            lane_totals=lambda: {"reconfigures": 1,
                                 "tiers": {"0": {"sent_bytes": 1, "recv_bytes": 1}},
                                 "hops": {"0": dict(hops)}},
            hop_records=lambda: [{"ts": 100.0, "tier": 0, "send_s": 0.001, "recv_s": 0.002,
                                  "comb_s": 0.0005, "nbytes": 4096}],
        ),
        _link_ewma={"recv_gbps": 1.0, "send_gbps": 1.0, "rtt_ms": 0.5},
        _ledger=SimpleNamespace(snapshot=lambda: {
            "steps": 1, "goodput_ratio": 0.9, "compute_s": 1.0,
            "lost_s": {c: 0.0 for c in LOST_CAUSES}}),
        _replica_id="g0:lint",
        _hop_hist={},
        _hop_hist_last_ts=0.0,
        _hop_hist_lock=threading.Lock(),
    )
    wm = WorkerMetrics("g0:lint", lambda: Manager._worker_metrics_snapshot(fake))
    wm.add_section(lambda: Manager._render_hop_histograms(fake))
    return _families(wm.render_prometheus())


def documented() -> str:
    out = []
    for rel in _DOC_FILES:
        with open(os.path.join(_REPO, rel), "r", encoding="utf-8") as f:
            out.append(f.read())
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m torchft_tpu_torch.tools.metrics_lint",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--verbose", action="store_true",
                    help="print every family with its doc status")
    args = ap.parse_args(argv)

    try:
        fams = sorted(lighthouse_families() | worker_families())
    except Exception as e:  # noqa: BLE001 - any scrape failure is exit 2
        print(f"metrics_lint: scrape failed: {e}", file=sys.stderr)
        return 2
    if not fams:
        print("metrics_lint: no families scraped (broken exporter?)", file=sys.stderr)
        return 2
    docs = documented()
    missing = [f for f in fams if f not in docs]
    if args.verbose:
        for f in fams:
            print(f"{'ok ' if f not in missing else 'MISS'} {f}")
    if missing:
        print(f"metrics_lint: {len(missing)} exported famil{'y' if len(missing) == 1 else 'ies'} "
              f"missing from {' + '.join(_DOC_FILES)}:", file=sys.stderr)
        for f in missing:
            print(f"  {f}", file=sys.stderr)
        return 1
    print(f"metrics_lint: {len(fams)} families, all documented")
    return 0


if __name__ == "__main__":
    sys.exit(main())
