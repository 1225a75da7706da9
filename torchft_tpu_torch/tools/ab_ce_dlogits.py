"""Design variants of the ce_dlogits kernel (K5), checked and timed in turns
on one card.

    python -m torchft_tpu_torch.tools.ab_ce_dlogits [--parent DIR]

Each variant is ``csrc/cross_entropy.cu`` with its epilogue or staging
changed by text substitution, built by its own ``nvcc`` into
``torchft_tpu_torch/_build/ab_ce_dlogits/``:

- ``kept``: the source as it is (4 stages, two 128-column staging halves
  a warpgroup, stored by TMA);
- ``full_tile_3_stages``: one 64 x 256 staging tile a warpgroup, stored
  at once, which leaves room for 3 stages only;
- ``direct_st_global``: no staging, the bf16 pairs stored from the
  accumulator fragment (16 contiguous bytes a quad a row), 4 stages;
- ``evict_first``: ``kept`` with the stores' L2 policy evict-first;
- ``parent`` (with ``--parent``): the ``cross_entropy.cu`` of another
  tree's ``csrc/`` directory, whose ce_lse (K4) is timed beside this
  tree's too.

Every variant is checked against ``_ce_dlogits_reference`` at five shapes
(flagship and ragged), with two launches compared bit for bit, before
anything is timed; then three rounds of CUDA-event times, the order
reversed each round (the card's clock drifts under sustained GEMM load),
with cuBLAS's ``x @ w`` of the same shape as a reference point.  Prints one
``AB {json}`` line.  Needs one card and ``nvcc``.
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

OUT = os.path.join(_build.BUILD_DIR, "ab_ce_dlogits")
SHAPES = ((300, 256, 1000), (1000, 128, 520), (256, 784, 1000), (129, 16, 8),
          (16384, 768, 32000))
TOL = (2e-2, 1e-6)  # chip_smoke.py's TOL_DLOGITS: rtol, atol

EPI_START = "      // The tile goes out in two 128-column halves through the staging\n"
EPI_END = "          tma_store_commit();\n        }\n      }\n"

VALUE = r'''            float p0 = ex2(fmaf(acc[4 * j + 2 * r], kLog2e, -lse2[r]));
            float p1 = ex2(fmaf(acc[4 * j + 2 * r + 1], kLog2e, -lse2[r]));
            if (tcol[r] == 8 * j) p0 -= 1.f;
            if (tcol[r] == 8 * j + 1) p1 -= 1.f;
'''

EPI_FULL_TILE = r'''      if (t == 0) tma_store_wait_read();
      named_barrier_sync(1 + c, 128);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
''' + VALUE + r'''            *reinterpret_cast<uint32_t*>(out + sw128_offset(r_local + 8 * r, 8 * j + col0,
                                                            OUT_BLOCK)) = pack_bf16(p0 * g, p1 * g);
        }
      }
      fence_proxy_async();
      named_barrier_sync(1 + c, 128);
      if (t == 0) {
        for (int b = 0; b < BN / 64; ++b) {
          const int col = v0 + 64 * b;
          if (row0 < N && col < V) tma_store_2d(&tm_dl, out + b * OUT_BLOCK, col, row0);
        }
        tma_store_commit();
      }
'''

EPI_DIRECT = r'''#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + r_local + 8 * r;
        if (row < N) {
          bf16* dst = dlp + static_cast<long long>(row) * V + v0 + col0;
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
''' + VALUE + r'''            if (v0 + 8 * j + col0 < V) {
              *reinterpret_cast<uint32_t*>(dst + 8 * j) = pack_bf16(p0 * g, p1 * g);
            }
          }
        }
      }
'''

HINTED_STORE = r'''{
              uint64_t pol;
              asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
              asm volatile(
                  "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint "
                  "[%0, {%2, %3}], [%1], %4;\n" ::"l"(reinterpret_cast<uint64_t>(&tm_dl)),
                  "r"(smem_u32(out + b * OUT_BLOCK)), "r"(col), "r"(row0), "l"(pol)
                  : "memory");
            }'''

VARIANTS = ("kept", "full_tile_3_stages", "direct_st_global", "evict_first")


def _sub(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"expected one {old[:60]!r} in cross_entropy.cu, found {text.count(old)}")
    return text.replace(old, new)


def _epilogue(text: str, new: str) -> str:
    i = text.index(EPI_START)
    j = text.index(EPI_END, i) + len(EPI_END)
    return text[:i] + new + text[j:]


def variant_source(name: str, src: str) -> str:
    """``cross_entropy.cu`` of one variant, from the kept source ``src``."""
    if name == "kept":
        return src
    if name == "full_tile_3_stages":
        src = _sub(src, "constexpr int STAGES = 4;", "constexpr int STAGES = 3;")
        src = _sub(src, "alignas(1024) bf16 out[2][64 * HALF];", "alignas(1024) bf16 out[2][64 * BN];")
        return _epilogue(src, EPI_FULL_TILE)
    if name == "direct_st_global":
        src = _sub(src, "  alignas(1024) bf16 out[2][64 * HALF];\n", "")
        src = _sub(src, "    unsigned char* out = reinterpret_cast<unsigned char*>(sm.out[c]);\n", "")
        src = _sub(src, "const __grid_constant__ CUtensorMap tm_dl, const int* __restrict__ targets,",
                   "const __grid_constant__ CUtensorMap tm_dl, bf16* __restrict__ dlp,\n"
                   "                      const int* __restrict__ targets,")
        src = _sub(src, "tm_x, tm_w, tm_dl, static_cast<const int*>(targets),",
                   "tm_x, tm_w, tm_dl, static_cast<bf16*>(dl), static_cast<const int*>(targets),")
        return _epilogue(src, EPI_DIRECT)
    if name == "evict_first":
        return _sub(src, "tma_store_2d(&tm_dl, out + b * OUT_BLOCK, col, row0);", HINTED_STORE)
    raise ValueError(name)


def _build_one(name: str, csrc: str, text: str) -> "tuple[str, str]":
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), d)
    with open(os.path.join(d, "cross_entropy.cu"), "w") as f:
        f.write(text)
    log = _build._run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-I", d,
                       "-o", os.path.join(d, "lib.so"), os.path.join(d, "cross_entropy.cu")],
                      timeout=900)
    return name, log


def build(parent: "str | None") -> "dict[str, dict[str, int]]":
    """Builds every variant; returns name -> ptxas spill bytes by kernel."""
    shutil.rmtree(OUT, ignore_errors=True)
    with open(os.path.join(_build.CSRC_DIR, "cross_entropy.cu")) as f:
        src = f.read()
    jobs = [(n, _build.CSRC_DIR, variant_source(n, src)) for n in VARIANTS]
    if parent:
        with open(os.path.join(parent, "cross_entropy.cu")) as f:
            jobs.append(("parent", parent, f.read()))
    with ThreadPoolExecutor(len(jobs)) as pool:
        logs = dict(pool.map(lambda job: _build_one(*job), jobs))
    return {n: {re.search(r"ce_\w+?_kernel", k).group(0): v
                for k, v in _build.spill_bytes(log).items()} for n, log in logs.items()}


def measure(names: "list[str]") -> dict:
    """Checks every variant, then times them in turns (run in a child
    process: a faulty variant that hangs is killed by the parent)."""
    import torch

    from torchft_tpu_torch.ops import cross_entropy as C

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    P, I = ctypes.c_void_p, ctypes.c_int
    dl_fns, lse_fns, new_abi = {}, {}, {}
    for name in names:
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        with open(os.path.join(OUT, name, "cross_entropy.cu")) as f:
            new_abi[name] = bool(re.search(r"tf_ce_dlogits\([^)]*int blocks", f.read()))
        dl_fns[name] = lib.tf_ce_dlogits
        dl_fns[name].argtypes = [P] * 6 + [I] * (4 if new_abi[name] else 3) + [P]
        lse_fns[name] = lib.tf_ce_lse
        lse_fns[name].argtypes = [P] * 4 + [I] * 6 + [P]
        dl_fns[name].restype = lse_fns[name].restype = I

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    def run_dl(name, x, w, t, lse, scale, out):
        n, e = x.shape
        args = [x.data_ptr(), w.data_ptr(), t.data_ptr(), lse.data_ptr(), scale.data_ptr(),
                out.data_ptr(), n, e, w.shape[1]] + ([blocks] if new_abi[name] else [])
        rc = dl_fns[name](*args, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    def run_lse(name, x, w, part, out):
        n, e = x.shape
        per, sl = C._vocab_slices(n, w.shape[1], blocks)
        rc = lse_fns[name](x.data_ptr(), w.data_ptr(), part.data_ptr(), out.data_ptr(), n, e,
                           w.shape[1], per, sl, blocks, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")

    def ms(fn, reps=5):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    result = {"checks": {}, "ms": {}}
    one = torch.ones(1, device=dev)
    for n, e, v in SHAPES:
        x, w = randn(n, e), randn(e, v, std=e ** -0.5)
        t = torch.randint(0, v, (n,), generator=gen, device=dev).to(torch.int32)
        lse = C._ce_lse_reference(x, w)
        ref = C._ce_dlogits_reference(x.float(), w.float(), t, lse, 1.0)
        allowed = TOL[0] * ref.abs() + TOL[1]
        for name in names:
            first = torch.full((n, v), float("nan"), device=dev, dtype=torch.bfloat16)
            second = torch.empty_like(first)
            run_dl(name, x, w, t, lse, one, first)
            run_dl(name, x, w, t, lse, one, second)
            ratio = float(((first.float() - ref).abs() / allowed).max())
            same = bool(torch.equal(first, second))
            print(f"{name} N={n} E={e} V={v}: worst err/allowed {ratio:.4f}, bitwise repeat "
                  f"{same}", flush=True)
            result["checks"][f"{name} {n}x{e}x{v}"] = [ratio, same]
            if not (ratio <= 1.0 and same):
                raise AssertionError(f"{name} fails at N={n} E={e} V={v}")
        del ref, allowed
        torch.cuda.empty_cache()

    n, e, v = SHAPES[-1]
    x, w = randn(n, e), randn(e, v, std=e ** -0.5)
    t = torch.randint(0, v, (n,), generator=gen, device=dev).to(torch.int32)
    lse = C._ce_lse_reference(x, w)
    g = torch.full((1,), 1.0 / n, device=dev)
    out = torch.empty((n, v), device=dev, dtype=torch.bfloat16)
    per, sl = C._vocab_slices(n, v, blocks)
    part, lse_out = torch.empty((sl, n), device=dev), torch.empty(n, device=dev)
    lse_names = [m for m in ("kept", "parent") if m in names]
    for rnd in range(3):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            result["ms"].setdefault(f"ce_dlogits {name}", []).append(
                ms(lambda: run_dl(name, x, w, t, lse, g, out)))
        for name in (lse_names if rnd % 2 == 0 else lse_names[::-1]):
            result["ms"].setdefault(f"ce_lse {name}", []).append(
                ms(lambda: run_lse(name, x, w, part, lse_out)))
        result["ms"].setdefault("cuBLAS x @ w", []).append(ms(lambda: torch.matmul(x, w)))
    for k, vals in result["ms"].items():
        print(f"{k}: " + " ".join(f"{q:.4f}" for q in vals) + " ms", flush=True)
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", help="another tree's torchft_tpu_torch/csrc directory")
    parser.add_argument("--measure", nargs="+", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.measure:
        print("AB " + json.dumps(measure(args.measure)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    spills = build(args.parent)
    for name, by_kernel in spills.items():
        print(f"ptxas spill bytes, {name}: {by_kernel}", flush=True)
    names = list(spills)
    proc = subprocess.run([sys.executable, "-m", "torchft_tpu_torch.tools.ab_ce_dlogits",
                           "--measure", *names], timeout=600,
                          cwd=os.path.dirname(_build._PKG_DIR))
    return proc.returncode


if __name__ == "__main__":
    sys.exit(main())
