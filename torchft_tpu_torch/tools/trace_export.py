"""Export merged multi-replica metrics JSONL as a Chrome/Perfetto trace.

The port's counterpart of the JAX package's ``tools/trace_export.py``::

    python -m torchft_tpu_torch.tools.trace_export <run>/metrics.jsonl
    # -> <run>/trace.json; open it in ui.perfetto.dev

or point it at a directory and it collects every ``*.jsonl`` (and
``flight_*.json`` / ``hops_*.json`` dump) inside::

    python -m torchft_tpu_torch.tools.trace_export --workdir <run>

The output is standard Chrome trace-event JSON: one process per replica
group, one track per incarnation, phase slices with ``step`` and
``slice_gen``, fault instants, clock-aligned across replicas at the
``step_summary`` commit barrier (:mod:`torchft_tpu_torch.obs.trace`).

``--quick`` builds a synthetic 2-replica stream (worker spans, the
lighthouse's flight view and a hop timeline), exports it, validates the
trace, writes a synthetic kill's incident bundle from the same stream and
reads back its verdict (``incident_bundle_ok``: it must name the victim),
and prints a JSON summary; it exits non-zero on any problem.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile

from torchft_tpu_torch.obs import incident as obs_incident
from torchft_tpu_torch.obs import trace as obs_trace


def incident_roundtrip(events: list) -> bool:
    """A synthetic kill's bundle (the stream as its span tail, a
    ``replica_stale`` trigger for group 1 at step 4) written, finalized and
    read back: True when the verdict names the victim.  Raises on a
    bundle that cannot be written or read."""
    broot = tempfile.mkdtemp(prefix="tpuft_incident_quick_")
    try:
        bundle = os.path.join(broot, "incident_4")
        os.makedirs(bundle)
        with open(os.path.join(bundle, "spans_tail.jsonl"), "w", encoding="utf-8") as f:
            for ev in events:
                f.write(json.dumps(ev) + "\n")
        trig = {"id": 1, "reason": "replica_stale", "replica_id": "1:b1", "step": 4,
                "ts_ms": 1_700_000_002_400, "detail": 500.0}
        with open(os.path.join(bundle, "incident.json"), "w", encoding="utf-8") as f:
            json.dump({"schema": 1, "incidents": [trig],
                       "artifacts": {"spans_tail.jsonl": "tail"}}, f)
        v = obs_incident.finalize_bundle(bundle, broot).get("verdict", {})
        return bool(v.get("kind") == "kill" and v.get("replica") == "1"
                    and v.get("lost_s") is not None
                    and obs_incident.load_bundle(bundle)["manifest"]["incidents"])
    finally:
        shutil.rmtree(broot, ignore_errors=True)


def quick(out: str, align: bool) -> dict:
    """The ``--quick`` smoke: summary dict with ``ok`` and ``problems``."""
    events = obs_trace.synthetic_stream(n_replicas=2, steps=4)
    events += obs_trace.synthetic_flight_stream(n_replicas=2, steps=4)
    events += obs_trace.synthetic_hop_stream(n_replicas=2, steps=4)
    events.sort(key=lambda ev: ev["ts"])
    built = obs_trace.build_trace(events, align=align)
    problems = obs_trace.validate_trace(built)
    cp_tracks = built.get("otherData", {}).get("control_plane", {})
    if not cp_tracks:
        problems.append("control-plane track missing from --quick trace")
    dp_tracks = sum(
        1 for ev in built["traceEvents"]
        if ev.get("ph") == "M" and ev.get("name") == "thread_name"
        and " dp:" in str(ev.get("args", {}).get("name", ""))
    )
    if not dp_tracks:
        problems.append("data-plane hop track missing from --quick trace")
    hop_slices = sum(1 for ev in built["traceEvents"] if ev.get("cat") == "hop")
    if not hop_slices:
        problems.append("no hop slices in --quick trace")
    incident_ok = False
    try:
        incident_ok = incident_roundtrip(events)
    except Exception as e:  # noqa: BLE001 - reported in the summary, which fails
        problems.append(f"incident bundle roundtrip raised: {e}")
    if not incident_ok and not problems:
        problems.append("incident bundle verdict failed to name the victim")
    with open(out, "w", encoding="utf-8") as f:
        json.dump(built, f)
    return {
        "ok": not problems,
        "out": out,
        "input_events": len(events),
        "trace_events": len(built["traceEvents"]),
        "replicas": len(built.get("otherData", {}).get("replicas", {})),
        "control_plane_tracks": len(cp_tracks),
        "data_plane_tracks": dp_tracks,
        "hop_slices": hop_slices,
        "incident_bundle_ok": incident_ok,
        "problems": problems,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m torchft_tpu_torch.tools.trace_export",
        description="Merge tpu-ft metrics JSONL streams into a Chrome/Perfetto trace.json "
        "(one track per replica).",
    )
    ap.add_argument("paths", nargs="*", help="metrics.jsonl file(s)")
    ap.add_argument("--workdir", help="collect every *.jsonl (and flight_*.json, hops_*.json "
                    "dump) under this directory instead")
    ap.add_argument("--flight", action="append", default=[], metavar="FLIGHT_JSON",
                    help="flight-recorder dump(s) to merge as a control-plane track")
    ap.add_argument("--hops", action="append", default=[], metavar="HOPS_JSON",
                    help="hop-timeline dump(s) (hops_<replica>.json) to merge as per-lane tracks")
    ap.add_argument("-o", "--out", help="output path (default: trace.json next to the first "
                    "input)")
    ap.add_argument("--no-align", action="store_true",
                    help="skip the step_summary commit-barrier clock alignment")
    ap.add_argument("--quick", action="store_true",
                    help="self-contained smoke: synthetic 2-replica stream -> export -> "
                    "schema validation")
    args = ap.parse_args(argv)

    if args.quick:
        out = args.out
        if out is None:
            fd, out = tempfile.mkstemp(prefix="tpuft_trace_", suffix=".json")
            os.close(fd)
        summary = quick(out, align=not args.no_align)
        print(json.dumps(summary))
        return 0 if summary["ok"] else 1

    paths, flight_paths, hops_paths = list(args.paths), list(args.flight), list(args.hops)
    if args.workdir:
        paths += sorted(glob.glob(os.path.join(args.workdir, "**", "*.jsonl"), recursive=True))
        flight_paths += sorted(glob.glob(os.path.join(args.workdir, "**", "flight_*.json"),
                                         recursive=True))
        hops_paths += sorted(glob.glob(os.path.join(args.workdir, "**", "hops_*.json"),
                                       recursive=True))
    if not paths and not flight_paths and not hops_paths:
        ap.error("no input: pass metrics.jsonl path(s), --flight, --hops, or --workdir")
    first = (paths + flight_paths + hops_paths)[0]
    out = args.out or os.path.join(os.path.dirname(first) or ".", "trace.json")
    summary = obs_trace.export(paths, out, align=not args.no_align, flight_paths=flight_paths,
                               hops_paths=hops_paths)
    print(json.dumps(summary))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
