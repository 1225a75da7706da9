"""Incident bundle CLI: capture from a live lighthouse, or re-verdict an
existing bundle.

The port's counterpart of the JAX package's ``tools/incident.py``.
Capture (a live lighthouse and a run directory)::

    python -m torchft_tpu_torch.tools.incident capture <workdir> \\
        --lighthouse http://host:port
    # polls /incident.json once; for every recorded trigger, writes
    # incident_<step>/ under <workdir> (the lighthouse's state, span tails,
    # any dumps already on disk) and prints the manifest with its verdict

Re-verdict (post-mortem, the bundle already on disk)::

    python -m torchft_tpu_torch.tools.incident verdict <workdir>/incident_42 [--json]

The work is :mod:`torchft_tpu_torch.obs.incident`'s, the code the
launcher's incident watcher drives; this is the operator's entry point.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

from torchft_tpu_torch.obs import incident as obs_incident


def _describe(bundle: str, v: dict) -> str:
    line = (f"{bundle}: kind={v.get('kind')} replica={v.get('replica')} "
            f"cause={v.get('cause')} lost_s={v.get('lost_s')}")
    # Culprit attribution (goodput_floor / slo_burn verdicts): who ate the
    # window and how much was charged.
    if v.get("culprit_replica"):
        line += f" culprit={v['culprit_replica']} charged_s={v.get('charged_seconds')}"
        if v.get("culprit_region"):
            line += f" region={v['culprit_region']}"
    if v.get("burn_fast") is not None:
        line += f" burn_fast={v.get('burn_fast')} burn_slow={v.get('burn_slow')}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m torchft_tpu_torch.tools.incident",
                                 description="Capture or analyze tpu-ft incident bundles")
    sub = ap.add_subparsers(dest="cmd", required=True)
    cap = sub.add_parser("capture", help="poll a live lighthouse and bundle")
    cap.add_argument("workdir", help="run workdir (bundles land here)")
    cap.add_argument("--lighthouse", required=True,
                     help="lighthouse dashboard address (http://host:port)")
    cap.add_argument("--metrics", action="append", default=[], metavar="JSONL",
                     help="metrics stream(s) to tail into the bundle (default: every *.jsonl "
                     "under the workdir)")
    cap.add_argument("--json", action="store_true")
    ver = sub.add_parser("verdict", help="re-verdict an existing bundle")
    ver.add_argument("bundle", help="incident_<step> directory")
    ver.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    if args.cmd == "capture":
        triggers = obs_incident.IncidentWatcher(args.lighthouse).poll()
        if not triggers:
            print("no incident triggers recorded", file=sys.stderr)
            return 1
        # An earlier bundle's spans_tail.jsonl is not a live stream: tailing
        # it again would count its records twice in every later verdict.
        metrics = args.metrics or sorted(
            p for p in glob.glob(os.path.join(args.workdir, "**", "*.jsonl"), recursive=True)
            if not any(part.startswith("incident_")
                       for part in os.path.relpath(p, args.workdir).split(os.sep)))
        manifests = []
        for trig in triggers:
            bundle = obs_incident.capture_bundle(args.workdir, args.lighthouse, trig,
                                                 metrics_paths=metrics)
            manifests.append({"bundle": bundle,
                              "manifest": obs_incident.finalize_bundle(bundle, args.workdir)})
        if args.json:
            json.dump(manifests, sys.stdout)
            print()
        else:
            for m in manifests:
                print(_describe(m["bundle"], m["manifest"].get("verdict", {})))
        return 0

    v = obs_incident.verdict(args.bundle)
    if args.json:
        json.dump(v, sys.stdout)
        print()
    else:
        print(json.dumps(v, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
