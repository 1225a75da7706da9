"""Per-op device profile of the flagship training step on the card.

The port's counterpart of the JAX package's ``tools/profile_step.py``:
``torch.profiler`` (CPU and CUDA activities) around chained
``TrainStep.full_step`` calls of the flagship transformer, parsed from the
Chrome trace it writes::

    python -m torchft_tpu_torch.tools.profile_step [--steps 3] [--json]
    python -m torchft_tpu_torch.tools.profile_step --trace saved.json [--steps 3]

Steps chain through their data: each ``full_step`` updates the parameters
in place and the next reads them.  Two steps warm up outside the window;
the window ends with one synchronisation.

The report (``--json`` prints it) has the JAX tool's ``schema: 1`` keys,
``device_total_ms_per_step`` (the sum of the device events' durations),
``ops`` (the top ops by device time, with launches a step) and
``by_class`` (ops grouped by their kernel's name, as the JAX tool groups
HLO names), and adds ``wall_ms_per_step`` (the window over the steps: from
the first step's start to the end of the last step or of its last device
event), ``device_busy_share`` (the union of the device intervals over the
window) and ``launches`` (every device op's launches a step).
Device events are the ``kernel``, ``gpu_memcpy`` and ``gpu_memset``
categories.  A trace without them (a CPU capture, or a machine where
CUPTI records nothing) reports its device part as absent, never as 0, and
the CLI exits non-zero with the reason.
"""

from __future__ import annotations

import argparse
import collections
import gzip
import json
import os
import re
import sys
import tempfile
from typing import Any, Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
NO_DEVICE_EVENTS = ("the trace holds no device events (kernel, gpu_memcpy or gpu_memset): "
                    "the capture ran without CUDA activity, or CUPTI recorded none")


def capture(out_path: str, steps: int = 3, device: str = "cuda", cfg: Any = None,
            batch: Optional[int] = None, seq: Optional[int] = None, warmup: int = 2) -> str:
    """Profiles ``steps`` chained ``full_step`` calls of the flagship model
    (or of ``cfg`` at ``batch`` x ``seq``) on ``device`` and writes the
    Chrome trace to ``out_path``; returns it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from torchft_tpu_torch.models import Transformer, flagship_config, loss_fn, resolve_device
    from torchft_tpu_torch.parallel import TrainStep

    dev = resolve_device(device)
    if cfg is None:
        cfg, batch, seq = flagship_config()
    model = Transformer(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)
    trainer = TrainStep(model, opt, loss_fn)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen, device=dev)
    b = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    for _ in range(warmup):
        trainer.full_step(b)
    sync()
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for i in range(steps):
            with record_function(f"profile_step#{i}"):
                loss = trainer.full_step(b)
        float(loss)  # the window's one synchronisation
        sync()
    prof.export_chrome_trace(out_path)
    return out_path


def _load(trace_path: str) -> List[dict]:
    opener = gzip.open if trace_path.endswith(".gz") else open
    with opener(trace_path, "rt") as fh:
        trace = json.load(fh)
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def op_class(name: str) -> str:
    """A kernel's class: its name without return type, namespaces, template
    arguments, parameters, or a tile configuration (from the first ``_``
    before a digit, as in cuBLAS's ``nvjet_tst_256x128_...``) and trailing
    digits."""
    base = re.sub(r"^void\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    base = re.split(r"[<(]", base, maxsplit=1)[0].strip()
    base = re.split(r"_\d", base.rsplit("::", 1)[-1], maxsplit=1)[0]
    return re.sub(r"[.\d_]+$", "", base) or name


def _union_us(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def build_report(trace_path: str, steps: int, top: int = 20) -> dict:
    """The op-time breakdown of a Chrome trace in ``torch.profiler``'s
    layout.  Without device events the device keys are None and
    ``device_absent`` says why."""
    events = [e for e in _load(trace_path) if e.get("ph") == "X" and "dur" in e]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES]
    # The window: the steps' annotations where the capture made them (else
    # every op but the profiler's own "Trace" span), to the last device
    # event's end.
    marks = [e for e in events if str(e.get("name", "")).startswith("profile_step#")]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in (marks or [e for e in events if e.get("cat") != "Trace"])]
    dev_iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device]
    extent_us = 0.0
    if spans:
        t0 = min(a for a, _ in spans)
        t1 = max([b for _, b in spans] + [b for _, b in dev_iv])
        extent_us = t1 - t0
        dev_iv = [(max(a, t0), b) for a, b in dev_iv if b > t0]
    rep: Dict[str, Any] = {
        "schema": 1,
        "trace": trace_path,
        "steps": steps,
        "wall_ms_per_step": round(extent_us / steps / 1e3, 4),
        "device_events": len(device),
    }
    if not device:
        rep.update({"device_total_ms_per_step": None, "device_busy_share": None,
                    "distinct_ops": 0, "ops": [], "by_class": [], "launches": {},
                    "device_absent": NO_DEVICE_EVENTS})
        return rep
    durs: Dict[str, float] = collections.defaultdict(float)
    counts: Dict[str, int] = collections.defaultdict(int)
    cats: Dict[str, str] = {}
    for e in device:
        durs[e["name"]] += float(e["dur"])
        counts[e["name"]] += 1
        cats.setdefault(e["name"], e["cat"])
    total = sum(durs.values())
    busy = _union_us(dev_iv)
    classes: Dict[str, float] = collections.defaultdict(float)
    for n, d in durs.items():
        classes[op_class(n)] += d
    rep.update({
        "device_total_ms_per_step": round(total / steps / 1e3, 4),
        "device_busy_share": round(busy / extent_us, 4) if extent_us > 0 else None,
        "distinct_ops": len(durs),
        "ops": [{"name": n, "ms_per_step": round(d / steps / 1e3, 4),
                 "launches_per_step": counts[n] / steps, "category": cats[n]}
                for n, d in sorted(durs.items(), key=lambda kv: -kv[1])[:top]],
        "by_class": [{"op_class": n, "ms_per_step": round(d / steps / 1e3, 4)}
                     for n, d in sorted(classes.items(), key=lambda kv: -kv[1])[:12]],
        "launches": {n: c / steps for n, c in counts.items()},
    })
    return rep


def launches_per_step(rep: dict, kernel: str) -> float:
    """Launches a step of the device ops whose name contains ``kernel``."""
    return sum(n for name, n in rep["launches"].items() if kernel in name)


def print_report(rep: dict) -> None:
    if rep["device_total_ms_per_step"] is None:
        print(f"wall {rep['wall_ms_per_step']:.2f} ms/step; device: absent "
              f"({rep['device_absent']})")
        return
    print(f"wall {rep['wall_ms_per_step']:.2f} ms/step; device ops "
          f"{rep['device_total_ms_per_step']:.2f} ms/step, busy share "
          f"{rep['device_busy_share']} ({rep['distinct_ops']} distinct ops, "
          f"{rep['steps']} steps)")
    print(f"\ntop {len(rep['ops'])} ops:")
    for op in rep["ops"]:
        print(f"  {op['ms_per_step']:8.3f} ms/step  {op['launches_per_step']:6.1f}/step  "
              f"[{op['category']}]  {op['name'][:90]}")
    print("\nby op class:")
    for c in rep["by_class"]:
        print(f"  {c['ms_per_step']:8.3f} ms/step  {c['op_class']}")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m torchft_tpu_torch.tools.profile_step",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="where the captured trace goes (default: a "
                    "new file in the temporary directory)")
    ap.add_argument("--trace", default=None, help="parse a saved Chrome trace instead of "
                    "capturing one")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    ap.add_argument("--json", action="store_true", help="machine-readable report on stdout")
    args = ap.parse_args(argv)
    path = args.trace
    if path is None:
        path = args.out
        if path is None:
            fd, path = tempfile.mkstemp(prefix="tpuft_profile_", suffix=".json")
            os.close(fd)
        capture(path, args.steps, device=args.device)
    rep = build_report(path, args.steps)
    if args.json:
        print(json.dumps(rep))
    else:
        print_report(rep)
    if rep["device_total_ms_per_step"] is None:
        print(f"profile_step: {NO_DEVICE_EVENTS}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
