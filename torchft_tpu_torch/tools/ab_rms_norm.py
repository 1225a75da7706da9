"""The RMSNorm kernel (K6) against another tree's, and against its own design
variants, checked and timed in turns on one card.

    python -m torchft_tpu_torch.tools.ab_rms_norm --parent DIR

DIR is another tree's ``torchft_tpu_torch/csrc`` directory (unpack it with
``git archive <commit> torchft_tpu_torch/csrc | tar -x -C <dir>`` into a
directory that git ignores).  Each library is built by its own ``nvcc``
into ``torchft_tpu_torch/_build/ab_rms_norm/<name>/``:

- ``new``: this tree's ``rmsnorm.cu``, launched with ``rms_plan``'s plan;
- ``st_plain`` and ``st_stream``: ``new`` with every store of out plain,
  or every one streaming (``st.global.cs``), where ``new`` streams f32
  rows only;
- ``w_flip``: ``new`` with w read the other way (f32 rows from a copy in
  shared memory, bf16 rows through L1);
- ``parent``: DIR's ``rmsnorm.cu``.

``new`` also runs under other plans at each timed shape, one choice of
``rms_plan`` changed at a time, where the ring still fits: ``rows_half``
and ``rows_double`` (rows a tile), ``stages_less`` and ``stages_more``,
``blocks_less`` (one block fewer an SM), ``warps_double`` (warps a
row).  Each tree's ``tf_rms_norm`` is bound by its own parameter
names, so a tree whose kernel takes no plan (x, w, out, rows, d, eps,
x_is_bf16, stream) runs beside this one.

Every library and plan is checked against ``_rms_reference`` within
``TOL_RMS`` / ``TOL_RMS_F32`` (``ops/rmsnorm.py``) at the four timed
shapes (x [16384, 768] and [8192, 2048], bf16 and f32, w f32), a partial
last tile and an unaligned width before anything is timed.  Then three
rounds, the order reversed each round, at each timed shape of:

- device time: a CUDA graph of REPS launches over inputs that rotate
  through at least twice the 50 MB L2 (so each launch reads x from device
  memory), the median of three replays' event times over REPS: the kernel
  apart from the host work of a call (every entry);
- eager time: REPS launches from Python back to back, event time over
  REPS: the kernel plus the host work of a bare ctypes launch (``new`` and
  ``parent``);
- beside them, as a reference point for the bytes alone, the device time
  of ``out.copy_(x)`` on the same tensors (one read and one write of x's
  bytes, no arithmetic).

Prints one ``AB {json}`` line (with the card's name and power limit).
Needs one card and ``nvcc``.  The measurement runs in a child process with
a time limit, so a faulty kernel that hangs is killed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

from torchft_tpu_torch import _build

OUT = os.path.join(_build.BUILD_DIR, "ab_rms_norm")
TIMED = ((16384, 768), (8192, 2048))
CHECKED = TIMED + ((16383, 768), (300, 1001))
REPS = 200
L2_BYTES = 50 * 2 ** 20
EPS = 1e-6

STORE = "constexpr bool kStreamStore = sizeof(T) == 4;"
W_SHARED = "constexpr bool kWShared = sizeof(T) == 2;"
SOURCE_VARIANTS = {
    "st_plain": (STORE, "constexpr bool kStreamStore = false;"),
    "st_stream": (STORE, "constexpr bool kStreamStore = true;"),
    "w_flip": (W_SHARED, W_SHARED.replace("== 2", "== 4")),
}
PLAN_VARIANTS = ("rows_half", "rows_double", "stages_less", "stages_more", "blocks_less",
                 "warps_double")
_CTYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p, "int": ctypes.c_int,
           "float": ctypes.c_float}


def signature(source: str) -> "list[tuple[str, type]]":
    """``tf_rms_norm``'s parameters in a ``rmsnorm.cu``: (name, ctypes type)."""
    sig = re.search(r'extern "C" int tf_rms_norm\(([^)]*)\)', source)
    if sig is None:
        raise ValueError("no tf_rms_norm in the source")
    params = []
    for param in sig.group(1).split(","):
        kind, name = param.strip().rsplit(" ", 1)
        if name.startswith("*"):
            kind, name = kind + "*", name[1:]
        params.append((name, _CTYPES[kind]))
    return params


def variant_sources(source: str) -> "dict[str, str]":
    """This tree's source and its variants, by name."""
    out = {"new": source}
    for name, (old, new) in SOURCE_VARIANTS.items():
        if source.count(old) != 1:
            raise ValueError(f"{name}: the source no longer holds {old!r} once")
        out[name] = source.replace(old, new)
    return out


def plan_variant(plan, name: str, rows: int, d: int, dtype, sms: int):
    """``plan`` with one choice changed (``PLAN_VARIANTS``), its shared memory
    and blocks worked out again as ``rms_plan`` does; None where the ring
    would not fit or the change is not possible."""
    from torchft_tpu_torch.ops import rmsnorm as R

    per_sm = max(1, plan.blocks // sms)
    rt, stages, gw = plan.rows_per_tile, plan.stages, plan.warps_per_row
    if name == "rows_half":
        rt //= 2
    elif name == "rows_double":
        rt *= 2
    elif name == "stages_less":
        stages -= 1
    elif name == "stages_more":
        stages += 1
    elif name == "blocks_less":
        per_sm -= 1
    elif name == "warps_double":
        gw *= 2
    if plan.path != "tma" or rt < 1 or stages < 2 or per_sm < 1 or gw > 8:
        return None
    row = d * dtype.itemsize
    fixed = plan.smem_bytes - (8 // plan.warps_per_row) * plan.stages * plan.rows_per_tile * row
    smem = fixed + (8 // gw) * stages * rt * row
    per_sm = min(per_sm, R.SMEM_PER_SM // (smem + 1024))
    if smem > R.SMEM_PER_BLOCK or per_sm < 1:
        return None
    blocks = min(sms * per_sm, -(-rows // (rt * (8 // gw))))
    return plan._replace(rows_per_tile=rt, stages=stages, warps_per_row=gw, smem_bytes=smem,
                         blocks=blocks)


def _build_one(name: str, text: str, csrc: str) -> "tuple[str, str]":
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), d)
    with open(os.path.join(d, "rmsnorm.cu"), "w") as f:
        f.write(text)
    log = _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", d,
                       "-o", os.path.join(d, "lib.so"), os.path.join(d, "rmsnorm.cu")],
                      timeout=900)
    return name, log


def build(parent: str) -> "dict[str, list[str]]":
    """Builds every library; returns name -> ptxas register and spill lines."""
    shutil.rmtree(OUT, ignore_errors=True)
    with open(os.path.join(_build.CSRC_DIR, "rmsnorm.cu")) as f:
        jobs = [(n, t, _build.CSRC_DIR) for n, t in variant_sources(f.read()).items()]
    with open(os.path.join(parent, "rmsnorm.cu")) as f:
        jobs.append(("parent", f.read(), parent))
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(pool.map(lambda job: _build_one(*job), jobs))
    return {n: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
            for n, log in logs.items()}


def measure(names: "list[str]") -> dict:
    """Checks every library and plan, then times them in turns (run in a
    child)."""
    import torch

    from torchft_tpu_torch.ops import rmsnorm as R

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = R._sms(dev)
    fns, params = {}, {}
    for name in names:
        with open(os.path.join(OUT, name, "rmsnorm.cu")) as f:
            params[name] = signature(f.read())
        fn = ctypes.CDLL(os.path.join(OUT, name, "lib.so")).tf_rms_norm
        fn.argtypes = [t for _, t in params[name]]
        fn.restype = ctypes.c_int
        fns[name] = fn

    def launch(name, plan, x, w, out):
        rows, d = x.shape
        values = {"x": x.data_ptr(), "w": w.data_ptr(), "out": out.data_ptr(), "rows": rows,
                  "d": d, "eps": EPS, "x_is_bf16": int(x.dtype == torch.bfloat16),
                  "stream": torch.cuda.current_stream().cuda_stream, **plan._asdict()}
        rc = fns[name](*(values[p] for p, _ in params[name]))
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    def events(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b)

    def eager_ms(step):
        for i in range(4):
            step(i)
        torch.cuda.synchronize()
        return events(lambda: [step(i) for i in range(REPS)]) / REPS

    def device_ms(step):
        for i in range(4):
            step(i)  # the shared-memory opt-in happens outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(REPS):
                step(i)
        graph.replay()
        torch.cuda.synchronize()
        return sorted(events(graph.replay) for _ in range(3))[1] / REPS

    tols = {torch.bfloat16: R.TOL_RMS, torch.float32: R.TOL_RMS_F32}
    result = {"checks": {}, "device_ms": {}, "eager_ms": {}, "copy_device_ms": {},
              "plans": {}, "reps": REPS}

    def check(key, name, plan, x, w, ref, tol):
        out = torch.full_like(x, float("nan"))
        launch(name, plan, x, w, out)
        ratio = float(((out.float() - ref).abs() / (tol["rtol"] * ref.abs() + tol["atol"])).max())
        print(f"{key}: worst err/allowed {ratio:.4f}", flush=True)
        result["checks"][key] = ratio
        if not ratio <= 1.0:
            raise AssertionError(f"{key} fails its tolerance")

    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in CHECKED:
            x = torch.randn(rows, d, generator=gen, device=dev).to(dtype)
            w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
            ref = R._rms_reference(x, w, EPS).float()
            plan = R.rms_plan(rows, d, dtype, sms)
            for name in names:
                check(f"{name} [{rows}, {d}] {str(dtype)[6:]}", name, plan, x, w, ref,
                      tols[dtype])

    for dtype in (torch.bfloat16, torch.float32):
        for rows, d in TIMED:
            shape = f"[{rows}, {d}] {str(dtype)[6:]}"
            plan = R.rms_plan(rows, d, dtype, sms)
            plans = {"": plan}
            for v in PLAN_VARIANTS:
                p = plan_variant(plan, v, rows, d, dtype, sms)
                if p is not None:
                    plans[" " + v] = p
            result["plans"][shape] = {k.strip() or "plan": p._asdict() for k, p in plans.items()}
            nbytes = rows * d * dtype.itemsize
            copies = max(2, -(-2 * L2_BYTES // nbytes))
            xs = [torch.randn(rows, d, generator=gen, device=dev).to(dtype) for _ in range(copies)]
            outs = [torch.empty_like(x) for x in xs]
            w = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
            ref = R._rms_reference(xs[0], w, EPS).float()
            entries = [(n, "", plan) for n in names]
            entries += [("new", k, p) for k, p in plans.items() if k]
            for name, suffix, p in entries[len(names):]:
                check(f"{name}{suffix} {shape}", name, p, xs[0], w, ref, tols[dtype])
            for rnd in range(3):
                for name, suffix, p in (entries if rnd % 2 == 0 else entries[::-1]):
                    def step(i, name=name, p=p):
                        launch(name, p, xs[i % copies], w, outs[i % copies])
                    key = f"{name}{suffix} {shape}"
                    result["device_ms"].setdefault(key, []).append(device_ms(step))
                    if not suffix and name in ("new", "parent"):
                        result["eager_ms"].setdefault(key, []).append(eager_ms(step))
                result["copy_device_ms"].setdefault(shape, []).append(
                    device_ms(lambda i: outs[i % copies].copy_(xs[i % copies])))
            del xs, outs
            torch.cuda.empty_cache()
    for kind in ("device_ms", "eager_ms", "copy_device_ms"):
        for k, vals in result[kind].items():
            print(f"{kind} {k}: " + " ".join(f"{q:.4f}" for q in vals), flush=True)
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another tree's torchft_tpu_torch/csrc directory")
    parser.add_argument("--measure", nargs="+", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.measure:
        res = measure(args.measure)
        res["card"] = os.environ.get("AB_CARD", "")
        print("AB " + json.dumps(res), flush=True)
        return 0
    if not args.parent:
        parser.error("--parent is required")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    logs = build(args.parent)
    for name, lines in logs.items():
        for line in lines:
            print(f"ptxas {name}: {line}", flush=True)
    proc = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.tools.ab_rms_norm",
                           "--measure", "new", "parent", *SOURCE_VARIANTS], timeout=900,
                          cwd=os.path.dirname(_build._PKG_DIR), env={**os.environ, "AB_CARD": card})
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
