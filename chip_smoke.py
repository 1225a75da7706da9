#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py     # the whole check, one card

Phases, each fatal on failure (the script exits non-zero and prints no
result):

1. Card: its name and power limit (nvidia-smi).
2. Build: the native coordination core (g++) and every Hopper kernel
   (one nvcc per csrc/*.cu, all at once), with their build times and
   ptxas reports; any spill in a wgmma kernel (WGMMA_KERNELS) fails.
3. Kernel checks: every kernel against its plain PyTorch version on the
   card, at the flagship shapes (flash and cross-entropy in bf16; RMSNorm
   with bf16 x and f32 w, plus ragged, 3-D and f32 cases; flash also at
   S 4096 and a ragged S 1000; cross-entropy also at ragged (N, E, V) =
   (300, 256, 1000), and dlogits at (1000, 128, 520) and (256, 784,
   1000)), element by element within the stated tolerances (TOL_*); each
   check must also reject a planted fault (a tile left out of a loop, a
   mask skipped on the diagonal tile or past V, a term dropped, a
   statistic over half a row), so a tolerance loose enough to pass a
   broken kernel fails the run, and two launches of each flash backward
   kernel and of ce_dlogits on the same inputs must agree bit for bit.
   Then CUDA-event times of the kernel, the plain version, one library
   call where PyTorch has one (and cuBLAS's product of the cross-entropy
   kernels' shape as a reference point),
   and the bound (the least time the card could take: bytes over 3.35 TB/s
   or bf16 operations over 989 TFLOP/s, the H100 SXM peaks at 700 W).
4. RMSNorm entry point: ``rms_norm_pallas`` forward and backward through
   autograd on flagship activations ([16, 1024, 768] bf16, w f32), with
   the launch counts set to 0 just before and read just after: the kernel
   launches exactly once a call.  (No model calls it, in the port as in
   the JAX package, whose models use the plain ``rms_norm``.)
5. Flagship training: a lighthouse, then two replica groups as two
   processes on the one card, each training the flagship transformer (12
   layers, d_model 768, 6 x 128 heads, vocab 32000, seq 1024, batch 16)
   under the fault-tolerant loop (Manager -> pipelined GradientAverager
   over TCPCollective with its defaults: the native ring engine, 2 lanes,
   the f32 wire -> should_commit -> AdamW).  Group 0 starts alone; group 1
   starts after group 0 has committed SOLO_STEPS steps, heals from it over
   HTTPTransport, and both run merged to the same final step; group 0 then
   times plain full_steps (compute alone).  Asserted: every step commits,
   every loss is finite, group 1 healed, both groups end with the same
   params_sha256, both rings ran the native engine on 2 lanes and the f32
   wire, and every kernel of the path launched exactly as often as the
   steps require (flash kernels 12 a step, cross-entropy kernels 1 a step).
   Printed: the averager's last_stats, the merged step's split into the
   train thread's waits for the copies off the card, for the ring and for
   the copies back, and params_sha256 beside the previous tree's
   (PREVIOUS_PARAMS_SHA256; two groups on the f32 wire reduce each element
   by one IEEE sum and one division by 2 on any engine, lanes or stripes).
   Each group writes a metrics stream (``TPUFT_METRICS_PATH``) and dumps
   its ring's sampled hops; the port's own consumers then read them:
   asserted, every committed step has a ``step_summary``, group 1's heal a
   ``heal`` span and group 0's snapshot a ``snapshot`` span, each merged
   step's ``allreduce_d2h`` / ``allreduce_merge`` / ``allreduce_h2d`` span
   sums equal the averager's ``last_stats`` waits within SPAN_TOL_MS, and
   ``obs.trace.validate_trace(build_trace(...))`` of both streams and the
   hops is clean; printed, each group's per-step phase table (wall, busy,
   quorum, heal, the three averager phases, commit vote, snapshot and the
   train thread's wait for it), ``obs.report.attribute`` per group, and
   ``report.data_plane`` / ``report.link_attribution`` (the hop stall
   split).
6. Kill and heal: ``torchft_tpu_torch.launch``'s Launcher runs two groups
   of ``python -m torchft_tpu_torch.examples.train_ddp`` on the card with
   an embedded lighthouse; after group 0 has KILL_MERGED merged commits,
   group 1 is killed with SIGKILL and restarted by the supervisor.
   Asserted: exactly one restart, a heal in the new incarnation, both FINAL
   lines at one step with one params_sha256, every loss finite.  Printed:
   the seconds from the kill to the restarted group's first merged commit,
   the survivor's uncommitted steps, its step ms alone and merged.  Both
   groups write one metrics stream, into which the drive writes a
   ``fault`` record at the kill (asserted); ``obs.report.deadwindow``'s
   dead time is printed beside ``recovery_s``.
7. Bare ring on the card's host: two in-process ranks allreduce the
   flagship's gradient payload (its parameter count in f32, 537 MB)
   BARE_RING_REPEATS times in each of three configurations: the Python
   engine on 1 lane (the earlier port's ring), the native engine on 2
   lanes, and the native engine on 2 lanes with the bf16 wire.  Asserted:
   the Python and native f32 results are bitwise equal, and both ranks
   hold the same bits.  Printed: seconds and GB/s of payload per op.
8. Raw-step profile: ``torchft_tpu_torch.tools.profile_step`` runs
   ``torch.profiler`` over PROFILE_STEPS chained flagship ``full_step``s.
   Printed: wall and device ms a step, the device busy share, the top 20
   ops and the op classes.  Asserted: the trace holds device events, and
   K1-K5 launch 12, 12, 12, 1 and 1 times a step.
9. The kernels line, ``{"kernels": [...]}``, then the last line,
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense, 700 W
PEAK_BYTES_PER_S = 3.35e12
MERGED_STEPS = 3          # steps both groups run with 2 participants
SOLO_STEPS = 4            # steps group 0 commits before group 1 starts
RAW_STEPS = 3             # group 0's plain full_step timings after the run
GROUP_TIMEOUT_S = 600.0
JOIN_GRACE_S = 1.0        # for group 1's first quorum request to reach the lighthouse
RMS_CALLS = 3             # rms_norm_pallas calls of the entry-point phase
KILL_STEPS = 2000         # train_ddp's --steps in the kill-and-heal phase
KILL_MERGED = 30          # group 0's merged commits before the kill
KILL_TIMEOUT_S = 420.0
BARE_RING_REPEATS = 3     # allreduces per configuration in the bare-ring phase
BARE_RING_TIMEOUT_S = 300.0
# params_sha256 of phase 5 on the previous tree (the single-lane Python
# ring), printed beside this run's.
PREVIOUS_PARAMS_SHA256 = "a6708cb8b8f7ca7d788b7e4aec47ebe288e95de86bd675e5311f02544f344981"
# The averager's span sums per merged step against its last_stats waits:
# one clock measures both, so they differ by rounding (1 us a span) and by
# the Manager's own allreduce_merge span at the vote (the drain of futures
# the averager already resolved).
SPAN_TOL_MS = 1.0
PROFILE_STEPS = 3         # chained raw steps in the profile phase
# The kernels built on wgmma, whose ptxas report must show no spill.
WGMMA_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel",
                 "ce_lse_kernel", "ce_dlogits_kernel")


def check_spills(build_logs: dict) -> None:
    """Fails unless ptxas reported 0 bytes of spill for every wgmma kernel:
    a spill inside the warpgroup pipeline serialises the wgmma."""
    from torchft_tpu_torch import _build

    spills = {}
    for log in build_logs.values():
        spills.update(_build.spill_bytes(log))
    for kernel in WGMMA_KERNELS:
        found = {f: b for f, b in spills.items() if kernel in f}
        if not found:
            raise AssertionError(f"no ptxas report for {kernel}")
        if any(found.values()):
            raise AssertionError(f"{kernel} spills: {found} bytes of spill stores + loads")
    print(f"  0 bytes of spill in {', '.join(WGMMA_KERNELS)}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# -- phase 3: kernel checks ---------------------------------------------------


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> dict:
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(t_ops, t_mem),
        "bound_by": "operations" if t_ops >= t_mem else "bytes",
        "flops": flops,
        "bytes": nbytes,
    }


# Element-wise tolerances, |got - ref| <= rtol |ref| + row x rms(ref's row)
# + atol, a row being the last axis (one output row of D or V values).
# Flash: bf16 outputs (2^-9 relative) and bf16 P / dS in the products,
# whose rounding scales with the magnitude of the row's terms, not with the
# element; the row term covers that, and a 1e-4 floor the f32 summation
# order where a row is all but zero (the first causal dq row).  A typical
# element in the causal bulk is ~0.05, so the floor is 0.2% of it.
# Cross-entropy dlogits at scale 1: bf16 outputs, logits from the same bf16
# inputs with f32 accumulation; a typical off-target entry is ~2e-5, so the
# floor is 1e-6.
TOL_FLASH = {"rtol": 1e-2, "row": 2e-2, "atol": 1e-4}
TOL_LSE = {"rtol": 0.0, "row": 0.0, "atol": 1e-4}
TOL_DLOGITS = {"rtol": 2e-2, "row": 0.0, "atol": 1e-6}
# RMSNorm: one rounding of an f32 result on each side; results that differ
# in the last f32 bits (rsqrtf, the shuffle-tree sum) can round one bf16
# step apart, up to 2^-7 of the value just above a power of two, so
# 1.6e-2 |ref| allows two steps; f32 outputs 1e-5 |ref|.  The gradients
# (closed form against autograd's chain, both f32, dx rounded to bf16) add
# a row term for dx's cancellation.
TOL_RMS = {"rtol": 1.6e-2, "row": 0.0, "atol": 1e-5}
TOL_RMS_F32 = {"rtol": 1e-5, "row": 0.0, "atol": 1e-6}
TOL_RMS_GRAD = {"rtol": 1e-2, "row": 1e-3, "atol": 1e-5}


def tol_text(tol: dict) -> str:
    return f"{tol['rtol']:g}|ref| + {tol['row']:g} rms(ref row) + {tol['atol']:g}"


def err_ratio(got, ref, tol: dict):
    """(max |got - ref|, rms(ref), max of |got - ref| over the allowed error,
    share of elements over it); the check passes while the ratio is <= 1."""
    ref = ref.float()
    err = (got.float() - ref).abs()
    allowed = tol["rtol"] * ref.abs() + tol["atol"]
    if tol["row"]:
        allowed += tol["row"] * ref.square().mean(-1, keepdim=True).sqrt()
    over = err / allowed
    return (float(err.max()), float(ref.square().mean().sqrt()), float(over.max()),
            float((over > 1).float().mean()))


def check(name: str, got, ref, tol: dict) -> dict:
    e, rms, ratio, _ = err_ratio(got, ref, tol)
    print(f"  {name}: max_abs_err {e:.3e}, rms(ref) {rms:.3e}, worst err/allowed "
          f"{ratio:.3f} (tolerance {tol_text(tol)})", flush=True)
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: error {ratio:.3f}x the tolerance {tol_text(tol)}")
    return {"max_abs_err": e, "ref_rms": rms, "err_over_tol": ratio, "tol": tol_text(tol)}


def reject(name: str, fault, ref, tol: dict) -> float:
    """A planted fault must fail the same check; returns its worst ratio."""
    _, _, ratio, share = err_ratio(fault, ref, tol)
    print(f"  planted fault {name}: worst err/allowed {ratio:.3f}, "
          f"{share:.4f} of elements over (rejected: {ratio > 1.0})", flush=True)
    if not ratio > 1.0:
        raise AssertionError(f"the check accepts the planted fault {name}")
    return ratio


def kernel_checks() -> dict:
    """Holds each kernel against its plain version, shows that each check
    rejects a planted fault, and returns per-kernel records (error,
    tolerance, times, bound) keyed by kernel name."""
    import torch
    import torch.nn.functional as F

    from torchft_tpu_torch.models import flagship_config
    from torchft_tpu_torch.ops import KERNELS
    from torchft_tpu_torch.ops import attention as A
    from torchft_tpu_torch.ops import cross_entropy as C

    cfg, batch, seq = flagship_config()
    H, D = cfg.n_heads, cfg.d_head
    BH = batch * H
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = D ** -0.5

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(torch.bfloat16)

    rec = {n: {} for n in KERNELS}

    def note(name, **kw):
        rec[name].update(kw)

    def keep(name, r, case):
        """Keeps the case with the largest error relative to its tolerance."""
        if r["err_over_tol"] >= rec[name].get("err_over_tol", -1.0):
            note(name, **r, checked=case)

    def diagonal_unmasked(q, k, v, scale):
        """What a causal forward that skipped the mask on the diagonal tile
        would give: keys above the diagonal but in the q row's own 128-row
        tile stay in the softmax."""
        s = torch.einsum("bqd,bkd->bqk", q, k) * scale
        rows = torch.arange(s.shape[1], device=s.device)[:, None]
        cols = torch.arange(s.shape[2], device=s.device)[None, :]
        keep = (cols <= rows) | (cols // 128 == rows // 128)
        p = torch.softmax(torch.where(keep, s, torch.full_like(s, A._NEG_INF)), dim=-1)
        return torch.einsum("bqk,bkd->bqd", p, v)

    # Flash forward: causal at the flagship shape, and one non-causal case.
    q, k, v = randn(BH, seq, D), randn(BH, seq, D), randn(BH, seq, D)
    for causal in (True, False):
        o, lse = A.flash_fwd(q, k, v, scale, causal)
        o_ref, lse_ref = A._fa_reference(q.float(), k.float(), v.float(), scale, causal)
        keep("flash_fwd", check(f"flash_fwd causal={causal} O", o, o_ref, TOL_FLASH),
             f"O, flagship shape, causal={causal}")
        check(f"flash_fwd causal={causal} lse", lse, lse_ref, TOL_LSE)
        if causal:
            o_bad = A._fa_reference(q.float(), k.float(), v.float(), 1.05 * scale, causal)[0]
            note("flash_fwd", planted={
                "O with the softmax scale 5% high": reject(
                    "O with the softmax scale 5% high", o_bad, o_ref, TOL_FLASH),
                "O with the diagonal tile unmasked": reject(
                    "O with the diagonal tile unmasked",
                    diagonal_unmasked(q.float(), k.float(), v.float(), scale), o_ref, TOL_FLASH),
            })

    def planted_bwd(q, k, v, o, lse, do, dq, dv, rq, rv) -> dict:
        """What a causal backward that skipped one tile of a loop would give:
        dq without kv tile 1 (keys 64-127) in the rows past it, and dv
        without the last q tile in the keys of the second half."""
        s = q.shape[1]
        qf, kf, vf, df = q.float(), k.float(), v.float(), do.float()
        delta = (df * o.float()).sum(-1, keepdim=True)
        t1 = slice(64, 128)
        p = torch.exp(torch.einsum("bqd,bkd->bqk", qf, kf[:, t1]) * scale - lse[..., None])
        ds = p * (torch.einsum("bqd,bkd->bqk", df, vf[:, t1]) - delta) * scale
        dq_part = torch.einsum("bqk,bkd->bqd", ds, kf[:, t1])
        dq_part[:, :128] = 0
        last = slice(s - 64, s)
        sl = torch.einsum("bqd,bkd->bqk", qf[:, last], kf) * scale
        rows = torch.arange(s - 64, s, device=q.device)[:, None]
        cols = torch.arange(s, device=q.device)[None, :]
        pl = torch.where(rows >= cols, torch.exp(sl - lse[:, last, None]), 0.0)
        dv_part = torch.einsum("bqk,bqd->bkd", pl, df[:, last])
        dv_part[:, : s // 2] = 0
        return {
            "dq without kv tile 1": reject("dq without kv tile 1", dq.float() - dq_part, rq,
                                           TOL_FLASH),
            "dv without the last q tile": reject("dv without the last q tile",
                                                 dv.float() - dv_part, rv, TOL_FLASH),
        }

    # Flash backward: flagship S=1024 (causal and not), S=4096 causal, where
    # the TPU package takes its two-pass form, and a ragged S=1000 (not a
    # multiple of the 128-row tiles), which also checks the forward.
    for bh, s, causal in ((BH, seq, True), (BH, seq, False), (8, 4096, True), (8, 1000, True),
                          (8, 1000, False)):
        qq, kk, vv, do = randn(bh, s, D), randn(bh, s, D), randn(bh, s, D), randn(bh, s, D)
        o, lse = A.flash_fwd(qq, kk, vv, scale, causal)
        case = f"S={s} BH={bh} causal={causal}"
        if s % 128:
            o_ref, lse_ref = A._fa_reference(qq.float(), kk.float(), vv.float(), scale, causal)
            keep("flash_fwd", check(f"flash_fwd {case} O", o, o_ref, TOL_FLASH), f"O, {case}")
            check(f"flash_fwd {case} lse", lse, lse_ref, TOL_LSE)
            del o_ref, lse_ref
        dq, dk, dv = A.flash_bwd(qq, kk, vv, o, lse, do, scale, causal)
        rq, rk, rv = A._fa_bwd_reference(
            qq.float(), kk.float(), vv.float(), o.float(), lse, do.float(), scale, causal
        )
        for nm, got, ref, kern in (("dq", dq, rq, "flash_bwd_dq"), ("dk", dk, rk, "flash_bwd_dkdv"),
                                   ("dv", dv, rv, "flash_bwd_dkdv")):
            keep(kern, check(f"flash_bwd {case} {nm}", got, ref, TOL_FLASH), f"{nm}, {case}")
        if (bh, s, causal) == (BH, seq, True):
            faults = planted_bwd(qq, kk, vv, o, lse, do, dq, dv, rq, rv)
            note("flash_bwd_dq", planted={"dq without kv tile 1": faults["dq without kv tile 1"]})
            note("flash_bwd_dkdv",
                 planted={"dv without the last q tile": faults["dv without the last q tile"]})
            # Determinism: a second launch on the same inputs, bit for bit.
            dq2, dk2, dv2 = A.flash_bwd(qq, kk, vv, o, lse, do, scale, causal)
            for kern, same in (("flash_bwd_dq", torch.equal(dq, dq2)),
                               ("flash_bwd_dkdv", torch.equal(dk, dk2) and torch.equal(dv, dv2))):
                print(f"  flash_bwd {case}: two {kern} launches give bitwise equal results: "
                      f"{same}", flush=True)
                if not same:
                    raise AssertionError(f"{kern}: two launches on the same inputs differ")
                note(kern, bitwise_repeat=same)
            del dq2, dk2, dv2
        del qq, kk, vv, do, o, lse, dq, dk, dv, rq, rk, rv
        torch.cuda.empty_cache()

    # Cross-entropy at N=16384, E=768, V=32000.
    N, E, V = batch * seq, cfg.d_model, cfg.vocab_size
    x, w = randn(N, E), randn(E, V, std=E ** -0.5)
    t = torch.randint(0, V, (N,), generator=gen, device=dev)
    lse = C.ce_lse(x, w)
    lse_ref = C._ce_lse_reference(x, w)
    note("ce_lse", **check("ce_lse", lse, lse_ref, TOL_LSE), checked="lse")
    note("ce_lse", planted={"lse without the last vocab tile": reject(
        "lse without the last vocab tile", C._ce_lse_reference(x, w[:, :-64]), lse_ref,
        TOL_LSE)})
    one = torch.ones(1, device=dev)
    dl = C.ce_dlogits(x, w, t, lse_ref, one)
    dl_ref = C._ce_dlogits_reference(x.float(), w.float(), t, lse_ref, 1.0)
    note("ce_dlogits", **check("ce_dlogits (scale 1)", dl, dl_ref, TOL_DLOGITS),
         checked="dlogits at scale 1")
    onehot = torch.zeros_like(dl)
    onehot[torch.arange(N, device=dev), t] = -1.0
    # Consumer warpgroup 1's half of item (row tile 0, column tile 1) left
    # unwritten (here: zero).
    half_zeroed = dl.clone()
    half_zeroed[64:128, 256:512] = 0.0
    note("ce_dlogits", planted={
        "-onehot only": reject("-onehot only", onehot, dl_ref, TOL_DLOGITS),
        "rows 64:128 of columns 256:512 zeroed": reject(
            "rows 64:128 of columns 256:512 zeroed", half_zeroed, dl_ref, TOL_DLOGITS),
    })
    del onehot, half_zeroed
    # Determinism: a second launch on the same inputs, bit for bit.
    same = torch.equal(dl, C.ce_dlogits(x, w, t, lse_ref, one))
    print(f"  ce_dlogits: two launches give bitwise equal results: {same}", flush=True)
    if not same:
        raise AssertionError("ce_dlogits: two launches on the same inputs differ")
    note("ce_dlogits", bitwise_repeat=same)
    del dl, dl_ref, lse_ref
    torch.cuda.empty_cache()

    # Ragged cross-entropy: N and V not multiples of the tiles (the last
    # 256-column vocab tile has 24 zero-filled columns past V).
    n_r, e_r, v_r = 300, 256, 1000
    x_r, w_r = randn(n_r, e_r), randn(e_r, v_r, std=e_r ** -0.5)
    t_r = torch.randint(0, v_r, (n_r,), generator=gen, device=dev)
    case = f"N={n_r} E={e_r} V={v_r}"
    lse_r = C._ce_lse_reference(x_r, w_r)
    padded = -(-v_r // C._COLS_PER_TILE) * C._COLS_PER_TILE - v_r
    pad_fault = torch.logaddexp(lse_r, torch.full_like(lse_r, math.log(padded)))
    note("ce_lse", planted={**rec["ce_lse"]["planted"], "lse with the padding past V as logits 0":
                            reject("lse with the padding past V as logits 0", pad_fault, lse_r,
                                   TOL_LSE)})
    keep("ce_lse", check(f"ce_lse {case}", C.ce_lse(x_r, w_r), lse_r, TOL_LSE), f"lse, {case}")
    dl_r = C.ce_dlogits(x_r, w_r, t_r, lse_r, one)
    dl_r_ref = C._ce_dlogits_reference(x_r.float(), w_r.float(), t_r, lse_r, 1.0)
    keep("ce_dlogits", check(f"ce_dlogits {case} (scale 1)", dl_r, dl_r_ref, TOL_DLOGITS),
         f"dlogits at scale 1, {case}")
    # dlogits at the other edges of its tiles: 64-column boxes wholly past V
    # (V 520 in a 768-column span of tiles), and E not a multiple of the
    # 64-wide chunks (784).
    for n_r, e_r, v_r in ((1000, 128, 520), (256, 784, 1000)):
        x_r, w_r = randn(n_r, e_r), randn(e_r, v_r, std=e_r ** -0.5)
        t_r = torch.randint(0, v_r, (n_r,), generator=gen, device=dev)
        case = f"N={n_r} E={e_r} V={v_r}"
        lse_r = C._ce_lse_reference(x_r, w_r)
        keep("ce_dlogits", check(f"ce_dlogits {case} (scale 1)", C.ce_dlogits(x_r, w_r, t_r, lse_r,
                                                                             one),
                                 C._ce_dlogits_reference(x_r.float(), w_r.float(), t_r, lse_r,
                                                         1.0), TOL_DLOGITS),
             f"dlogits at scale 1, {case}")

    rms_checks(note, keep, gen, N, E)

    # -- times ------------------------------------------------------------
    print("timing (CUDA events, after warm-up):", flush=True)
    causal = True
    pairs = seq * (seq + 1) // 2
    o, lse = A.flash_fwd(q, k, v, scale, causal)
    do = randn(BH, seq, D)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    hs = BH * seq * D * 2  # bytes of one [BH, S, D] bf16 tensor
    rows = BH * seq * 4    # bytes of one [BH, S] f32 tensor
    q4, k4, v4, do4 = (x_.view(batch, H, seq, D) for x_ in (q, k, v, do))

    note("flash_fwd",
         ms=cuda_ms(lambda: A.flash_fwd(q, k, v, scale, causal), 20),
         plain_ms=cuda_ms(lambda: A._fa_reference(q, k, v, scale, causal), 5),
         library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True), 20),
         library_call="scaled_dot_product_attention forward",
         **bound(2 * 2 * pairs * D * BH, 4 * hs + rows))
    dkdv = KERNELS["flash_bwd_dkdv"]
    dqk = KERNELS["flash_bwd_dq"]
    plain_bwd = cuda_ms(lambda: A._fa_bwd_reference(q, k, v, o, lse, do, scale, causal), 3)
    q4r, k4r, v4r = (x_.detach().clone().requires_grad_() for x_ in (q4, k4, v4))
    out4 = F.scaled_dot_product_attention(q4r, k4r, v4r, is_causal=True)
    sdpa_bwd = cuda_ms(
        lambda: torch.autograd.grad(out4, (q4r, k4r, v4r), do4, retain_graph=True), 10
    )
    note("flash_bwd_dkdv",
         ms=cuda_ms(lambda: dkdv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                 BH, seq, D, scale, 1), 20),
         plain_ms=plain_bwd, library_ms=sdpa_bwd,
         library_call="scaled_dot_product_attention backward (dq, dk, dv together)",
         plain_call="_fa_bwd_reference (dq, dk, dv together)",
         **bound(4 * 2 * pairs * D * BH, 4 * hs + 2 * rows + 2 * hs))
    note("flash_bwd_dq",
         ms=cuda_ms(lambda: dqk(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                                lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                                BH, seq, D, scale, 1), 20),
         plain_ms=plain_bwd, library_ms=sdpa_bwd,
         library_call="scaled_dot_product_attention backward (dq, dk, dv together)",
         plain_call="_fa_bwd_reference (dq, dk, dv together)",
         **bound(3 * 2 * pairs * D * BH, 4 * hs + 2 * rows + hs))
    del q4r, k4r, v4r, out4
    lse_ce = C.ce_lse(x, w)
    g = torch.full((1,), 1.0 / N, device=dev)
    note("ce_lse",
         ms=cuda_ms(lambda: C.ce_lse(x, w), 5),
         plain_ms=cuda_ms(lambda: C._ce_lse_reference(x, w), 3),
         library_ms=None,
         # A reference point, not the function: cuBLAS's bf16 product of the
         # same shape, which writes the [N, V] logits K4 never stores.
         matmul_ms=cuda_ms(lambda: torch.matmul(x, w), 5),
         **bound(2 * N * E * V, N * E * 2 + E * V * 2 + N * 4))
    note("ce_dlogits",
         ms=cuda_ms(lambda: C.ce_dlogits(x, w, t, lse_ce, g), 5),
         plain_ms=cuda_ms(lambda: C._ce_dlogits_reference(x, w, t, lse_ce, g), 3),
         library_ms=None,
         # A reference point, not the function: cuBLAS's bf16 product of the
         # same shape, which writes as many bf16 bytes as K5 does.
         matmul_ms=cuda_ms(lambda: torch.matmul(x, w), 5),
         **bound(2 * N * E * V, N * E * 2 + E * V * 2 + 2 * N * 4 + 4 + N * V * 2))
    from torchft_tpu_torch.ops import rmsnorm as R

    # Four inputs in turn (100 MB of x, twice the 50 MB L2): each call reads
    # x from device memory, as a caller with a fresh activation would.
    xs = [randn(N, E) for _ in range(4)]
    wr = 1.0 + 0.1 * torch.randn(E, generator=gen, device=dev)
    wr_bf16 = wr.to(torch.bfloat16)
    turn = iter(range(1 << 30))

    def rotating(fn):
        return lambda: fn(xs[next(turn) % len(xs)])

    lib_dtype = F.rms_norm(xs[0], (E,), wr, 1e-6).dtype
    note("rms_norm",
         ms=cuda_ms(rotating(lambda x: R.rms_fwd(x, wr, 1e-6)), 100),
         plain_ms=cuda_ms(rotating(lambda x: R._rms_reference(x, wr, 1e-6)), 20),
         library_ms=cuda_ms(rotating(lambda x: F.rms_norm(x, (E,), wr, 1e-6)), 100),
         library_call=f"F.rms_norm(x bf16, ({E},), w f32, 1e-6), which returns {lib_dtype}",
         # The same call with w cast to bf16, the dtype pair PyTorch fuses.
         library_bf16w_ms=cuda_ms(rotating(lambda x: F.rms_norm(x, (E,), wr_bf16, 1e-6)), 100),
         # ~4 f32 operations an element take far less than the bytes' time:
         # the bound is the bytes.
         **bound(0.0, 2 * N * E * 2 + E * 4))
    del xs
    for name, r in rec.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.3f}"
        extra = f"  matmul_ms {r['matmul_ms']:.3f}" if "matmul_ms" in r else ""
        print(f"  {name}: kernel_ms {r['ms']:.3f}  plain_ms {r['plain_ms']:.3f}  "
              f"library_ms {lib}{extra}  bound_ms {r['bound_ms']:.4f} ({r['bound_by']})",
              flush=True)
    bwd = rec["flash_bwd_dkdv"]["ms"] + rec["flash_bwd_dq"]["ms"]
    print(f"  flash backward, flash_bwd_dkdv + flash_bwd_dq: {bwd:.3f} ms against "
          f"scaled_dot_product_attention's backward {sdpa_bwd:.3f} ms", flush=True)
    return rec


def rms_checks(note, keep, gen, n: int, e: int) -> None:
    """K6 against ``_rms_reference``: the flagship width (x [n, e] bf16, w
    [e] f32) with a planted fault, ragged and 3-D inputs in both dtype
    pairs, and the backward through autograd against the plain version's
    autograd."""
    import torch

    from torchft_tpu_torch.ops import rmsnorm as R

    dev = torch.device("cuda")
    eps = 1e-6

    def inputs(shape, dtype):
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        w = 1.0 + 0.1 * torch.randn(shape[-1], generator=gen, device=dev)
        return x, w

    x, w = inputs((n, e), torch.bfloat16)
    ref = R._rms_reference(x, w, eps)
    keep("rms_norm", check("rms_norm flagship x bf16", R.rms_norm_pallas(x, w, eps), ref,
                           TOL_RMS), f"x [{n}, {e}] bf16, w f32")
    half = x[:, : e // 2].float()
    inv_half = torch.rsqrt(half.square().mean(-1, keepdim=True) + eps)
    note("rms_norm", planted={"statistics over the first half of each row": reject(
        "statistics over the first half of each row", (x.float() * inv_half * w).to(x.dtype),
        ref, TOL_RMS)})
    for shape in ((300, 1000), (300, 1001), (4, 50, e), (e,)):
        for dtype, tol in ((torch.bfloat16, TOL_RMS), (torch.float32, TOL_RMS_F32)):
            xs, ws = inputs(shape, dtype)
            name = f"x {list(shape)} {str(dtype).split('.')[-1]}"
            keep("rms_norm", check(f"rms_norm {name}", R.rms_norm_pallas(xs, ws, eps),
                                   R._rms_reference(xs, ws, eps), tol), name)

    # Backward: the closed form after the kernel's forward, against
    # autograd through the plain version.
    g = torch.randn(n, e, generator=gen, device=dev).to(torch.bfloat16)
    grads = []
    for fn in (R.rms_norm_pallas, R._rms_reference):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        fn(xg, wg, eps).backward(g)
        grads.append((xg.grad, wg.grad))
    (dx, dw), (rdx, rdw) = grads
    check("rms_norm_pallas backward dx", dx, rdx, TOL_RMS_GRAD)
    check("rms_norm_pallas backward dw", dw, rdw, TOL_RMS_GRAD)
    torch.cuda.synchronize()


# -- phase 4: the RMSNorm entry point ------------------------------------------


def rms_entry_point() -> dict:
    """``rms_norm_pallas`` forward and backward through autograd on flagship
    activations, counts set to 0 just before and read just after."""
    import torch

    from torchft_tpu_torch.models import flagship_config
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts, rms_norm_pallas

    cfg, batch, seq = flagship_config()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(batch, seq, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    w = torch.ones(cfg.d_model, device=dev, requires_grad=True)
    reset_launch_counts()
    for _ in range(RMS_CALLS):
        xg = x.clone().requires_grad_()
        out = rms_norm_pallas(xg, w)
        out.float().square().mean().backward()
        if not (torch.isfinite(xg.grad).all() and torch.isfinite(w.grad).all()):
            raise AssertionError("rms_norm_pallas: non-finite gradients")
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {name: (RMS_CALLS if name == "rms_norm" else 0) for name in counts}
    if counts != want:
        raise AssertionError(f"rms_norm_pallas phase launched {counts}, expected {want}")
    print(f"  rms_norm_pallas x [{batch}, {seq}, {cfg.d_model}] bf16: {RMS_CALLS} forward + "
          f"backward calls, launches {counts['rms_norm']}", flush=True)
    return counts


# -- phase 5: one replica group (run as its own process) ---------------------


def run_group(args: argparse.Namespace) -> None:
    import logging
    from datetime import timedelta

    import torch

    from torchft_tpu_torch.checkpointing import HTTPTransport
    from torchft_tpu_torch.collectives import TCPCollective
    from torchft_tpu_torch.manager import Manager
    from torchft_tpu_torch.models import Transformer, flagship_config, loss_fn, resolve_device
    from torchft_tpu_torch.ops import launch_counts, reset_launch_counts
    from torchft_tpu_torch.parallel import TrainStep

    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format=f"[g{args.group}] %(message)s")
    group, run_dir = args.group, args.run_dir
    cfg, batch, seq = flagship_config()
    dev = resolve_device("cuda")
    model = Transformer(cfg, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1000 + group))
    # Every AdamW hyperparameter explicit (the JAX side's optax defaults differ).
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=1e-4)

    def state_dict():
        return {"model": model.state_dict(), "optim": opt.state_dict()}

    def load_state_dict(sd):
        model.load_state_dict(sd["model"])
        opt.load_state_dict(sd["optim"])

    def wait_for(path: str) -> None:
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while not os.path.exists(path):
            if time.monotonic() > deadline:
                raise TimeoutError(f"group {group}: {path} never appeared")
            time.sleep(0.05)

    timeout = timedelta(seconds=180)
    collective = TCPCollective(timeout=180.0, host="127.0.0.1")
    manager = Manager(
        collective=collective,
        load_state_dict=load_state_dict,
        state_dict=state_dict,
        min_replica_size=1,
        rank=0,
        world_size=1,
        replica_id=f"smoke_g{group}",
        lighthouse_addr=args.lighthouse,
        store_addr="127.0.0.1",
        manager_bind="127.0.0.1:0",
        checkpoint_transport=HTTPTransport(timeout=180.0, host="127.0.0.1"),
        timeout=timeout,
        quorum_timeout=timeout,
    )
    trainer = TrainStep(model, opt, loss_fn, manager)
    data = torch.Generator(device=dev).manual_seed(7 + group)

    reset_launch_counts()
    steps, merged, healed = [], 0, 0
    ring_seen: dict = {}
    while merged < MERGED_STEPS:
        if len(steps) > 100:
            raise RuntimeError("group never merged with its peer")
        before = manager.current_step()
        manager.start_quorum()
        if group == 1 and not steps:
            # This request waits at the lighthouse (1 of 2 healthy groups
            # joined) until group 0 joins too, so group 1 joins at step
            # SOLO_STEPS + 1 in every run: two runs of one tree take the same
            # steps and end with the same params_sha256.
            time.sleep(JOIN_GRACE_S)
            open(os.path.join(run_dir, "g1_up"), "w").close()
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=data, device=dev)
        b = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
        t0 = time.perf_counter()
        loss, committed = trainer.ft_step(b)
        loss_v = float(loss)  # waits for the step's kernels
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        participants = manager.num_participants()
        jumped = manager.current_step() - before > 1
        healed += int(jumped)
        rec = {"group": group, "step": manager.current_step(), "loss": loss_v,
               "committed": committed, "participants": participants,
               "ring": collective.size(), "healed": jumped, "step_s": dt}
        if collective.size() == 2:
            # The averager's last exchange: this step's (alone it returns
            # before any copy and keeps the previous step's stats), under
            # the step its spans carry.
            rec["exchange"] = dict(trainer.averager.last_stats)
            rec["span_step"] = before
            ring_seen = {"ring_engine": collective.ring_engine, "lanes": collective.lanes,
                         "wire": collective.wire_dtype}
        steps.append(rec)
        print("STEP " + json.dumps(rec), flush=True)
        if not committed:
            raise RuntimeError(f"group {group}: step {before} did not commit")
        if not math.isfinite(loss_v):
            raise RuntimeError(f"group {group}: loss {loss_v} is not finite")
        if participants == 2:
            merged += 1
        if group == 0 and manager.current_step() == SOLO_STEPS:
            open(os.path.join(run_dir, "g0_ready"), "w").close()
            wait_for(os.path.join(run_dir, "g1_up"))

    counts = launch_counts()
    # The ring's sampled hop timeline, for the trace and the data-plane
    # rollup of the stream.
    with open(os.path.join(run_dir, f"hops_g{group}.json"), "w") as f:
        json.dump({"replica_id": f"smoke_g{group}", "records": collective.hop_records(),
                   "lane_totals": collective.lane_totals()}, f)
    h = hashlib.sha256()
    for name, p in model.state_dict().items():
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    merged_recs = [r for r in steps if r["participants"] == 2]
    merged_s = [r["step_s"] for r in merged_recs]
    # Group 0's solo steps (ring of one: no gradient traffic), the first
    # one (warm-up) left out.
    solo_s = [r["step_s"] for r in steps[1:] if r["ring"] == 1]
    n_params = sum(p.numel() for p in model.parameters())
    tokens = batch * seq
    result = {
        "group": group,
        **ring_seen,
        "exchange_last_stats": merged_recs[-1]["exchange"],
        # Each merged step's waits, keyed by the step its spans carry.
        "exchange_by_step": {str(r["span_step"]): r["exchange"] for r in merged_recs},
        # Mean over the merged steps of the train thread's waits in the
        # averager: for the copies off the card, for the ring, for the
        # copies back.
        "merged_split_ms": {
            k: 1e3 * sum(r["exchange"][k] for r in merged_recs) / len(merged_recs)
            for k in ("d2h_wait_s", "ring_wait_s", "h2d_s")
        },
        "steps_run": len(steps),
        "final_step": manager.current_step(),
        "healed": healed,
        "launches": counts,
        "losses": [r["loss"] for r in steps],
        "params_sha256": h.hexdigest(),
        "heal_step_ms": [1e3 * r["step_s"] for r in steps if r["ring"] == 2
                         and r["participants"] == 1],
        "merged_step_ms": 1e3 * sum(merged_s) / len(merged_s),
        "tokens_per_s": tokens * len(merged_s) / sum(merged_s),
        "solo_step_ms": 1e3 * sum(solo_s) / len(solo_s) if solo_s else None,
        # 6 N per token for the dense layers plus the causal attention term
        # 6 L S d (the JAX bench's model-FLOP count).
        "model_flops_per_step": (6 * n_params + 6 * cfg.n_layers * seq * cfg.d_model) * tokens,
    }
    manager.shutdown()
    if group == 0:
        # The compute alone: TrainStep.full_step (forward, backward, AdamW;
        # no quorum, no cross-group average), timed after the FT run.
        raw = []
        for _ in range(RAW_STEPS):
            t0 = time.perf_counter()
            float(trainer.full_step(b))
            torch.cuda.synchronize()
            raw.append(time.perf_counter() - t0)
        result["raw_step_ms"] = 1e3 * sum(raw) / len(raw)
    print("RESULT " + json.dumps(result), flush=True)


# -- phase 5: the parent process -----------------------------------------------


def main_path(card: str) -> dict:
    from torchft_tpu_torch._native import LighthouseServer

    lighthouse = LighthouseServer(bind="127.0.0.1:0", http_bind="127.0.0.1:0",
                                  min_replicas=1, join_timeout_ms=100)
    run_dir = tempfile.mkdtemp(prefix="tpuft_smoke_")
    procs, readers, results, errors = {}, {}, {}, []

    def start(group: int) -> None:
        env = {**os.environ, "TPUFT_METRICS_PATH": os.path.join(run_dir, f"metrics_g{group}.jsonl")}
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--group", str(group),
             "--lighthouse", lighthouse.address(), "--run-dir", run_dir],
            stdout=subprocess.PIPE, text=True, cwd=HERE, env=env,
        )
        procs[group] = proc

        def read() -> None:
            assert proc.stdout is not None
            for line in proc.stdout:
                line = line.rstrip("\n")
                print(f"  [g{group}] {line}", flush=True)
                if line.startswith("RESULT "):
                    results[group] = json.loads(line[len("RESULT "):])

        readers[group] = threading.Thread(target=read, daemon=True)
        readers[group].start()

    def poll_failures() -> None:
        for g, p in procs.items():
            rc = p.poll()
            if rc not in (None, 0):
                errors.append(f"group {g} exited with {rc}")
        if errors:
            raise RuntimeError("; ".join(errors))

    try:
        t_start = time.monotonic()
        start(0)
        while not os.path.exists(os.path.join(run_dir, "g0_ready")):
            poll_failures()
            if time.monotonic() - t_start > GROUP_TIMEOUT_S:
                raise TimeoutError("group 0 never committed its solo steps")
            time.sleep(0.1)
        start(1)
        for g, p in procs.items():
            rc = p.wait(timeout=GROUP_TIMEOUT_S)
            readers[g].join(timeout=30)
            if rc != 0:
                raise RuntimeError(f"group {g} exited with {rc}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        lighthouse.shutdown()
    try:
        stream = stream_phase(run_dir, results, card)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    r0, r1 = results[0], results[1]
    if r0["final_step"] != r1["final_step"]:
        raise AssertionError(f"final steps differ: {r0['final_step']} vs {r1['final_step']}")
    if r1["healed"] != 1 or r0["healed"] != 0:
        raise AssertionError(f"expected group 1 to heal once: {r0['healed']}, {r1['healed']}")
    if r0["params_sha256"] != r1["params_sha256"]:
        raise AssertionError("the groups' final parameters differ")
    for r in (r0, r1):
        ring = (r.get("ring_engine"), r.get("lanes"), r.get("wire"))
        print(f"group {r['group']}: ring engine {ring[0]}, {ring[1]} lanes, {ring[2]} wire; "
              f"averager last_stats {json.dumps(r['exchange_last_stats'])}", flush=True)
        if ring != ("native", 2, "f32"):
            raise AssertionError(f"group {r['group']} ran the ring {ring}, expected the "
                                 f"defaults ('native', 2, 'f32')")
    same = r0["params_sha256"] == PREVIOUS_PARAMS_SHA256
    print(f"params_sha256 {r0['params_sha256']}; previous tree's {PREVIOUS_PARAMS_SHA256}: "
          f"{'equal' if same else 'DIFFERENT'}", flush=True)
    from torchft_tpu_torch.models import flagship_config

    cfg, batch, seq = flagship_config()
    per_step = {"flash_fwd": cfg.n_layers, "flash_bwd_dkdv": cfg.n_layers,
                "flash_bwd_dq": cfg.n_layers, "ce_lse": 1, "ce_dlogits": 1}
    for r in (r0, r1):
        for name, k in per_step.items():
            want = k * r["steps_run"]
            if r["launches"].get(name) != want:
                raise AssertionError(
                    f"group {r['group']}: {name} launched {r['launches'].get(name)} times, "
                    f"expected {want} ({k} x {r['steps_run']} steps)"
                )
    for r in (r0, r1):
        print(f"group {r['group']}: {r['steps_run']} steps to step {r['final_step']}, "
              f"merged step {r['merged_step_ms']:.1f} ms, {r['tokens_per_s']:.0f} tokens/s, "
              f"heal step {r['heal_step_ms']} ms ({card}); params_sha256 {r['params_sha256']}",
              flush=True)
    flops = r0["model_flops_per_step"]
    tokens = batch * seq
    for name, ms in (("raw full_step", r0["raw_step_ms"]), ("solo ft_step", r0["solo_step_ms"]),
                     ("merged ft_step", r0["merged_step_ms"])):
        print(f"group 0 {name}: {ms:.1f} ms, {tokens / ms * 1e3:.0f} tokens/s, "
              f"{flops / ms / 1e9:.1f} model TFLOP/s = "
              f"{flops / ms * 1e3 / PEAK_BF16_FLOPS:.4f} of the bf16 peak ({card})", flush=True)
    for r in (r0, r1):
        split = r["merged_split_ms"]
        print(f"group {r['group']} merged ft_step {r['merged_step_ms']:.1f} ms, of which the train "
              f"thread waited {split['d2h_wait_s']:.1f} ms for the copies off the card, "
              f"{split['ring_wait_s']:.1f} ms for the ring, {split['h2d_s']:.1f} ms for the "
              f"copies back (mean of {MERGED_STEPS} merged steps; {card})", flush=True)
    return {name: r0["launches"][name] + r1["launches"][name] for name in per_step}, stream


def stream_phase(run_dir: str, results: dict, card: str) -> dict:
    """Phase 5's metrics streams, read by the port's own consumers: every
    committed step has a step_summary, the heal a ``heal`` span, the donor
    a ``snapshot`` span; each merged step's averager spans sum to its
    ``last_stats`` waits within SPAN_TOL_MS; the merged trace validates;
    then the per-step phase table of each group, ``obs.report.attribute``
    per group, and the data-plane rollups of the stream and of the hops."""
    from torchft_tpu_torch.obs import report, trace

    paths = {g: os.path.join(run_dir, f"metrics_g{g}.jsonl") for g in (0, 1)}
    by_group = {g: report.read_events([p]) for g, p in paths.items()}
    events = report.read_events(list(paths.values()))
    hop_events = []
    for g in (0, 1):
        with open(os.path.join(run_dir, f"hops_g{g}.json")) as f:
            dump = json.load(f)
        hop_events += trace.hops_to_stream(dump)
        totals = dump["lane_totals"]["hops"].get("flat", {})
        print(f"  group {g}: {len(dump['records'])} sampled hops kept; lane_totals "
              f"{json.dumps(dump['lane_totals'])}", flush=True)
        if not dump["records"] or not totals.get("hops"):
            raise AssertionError(f"group {g}: the ring recorded no hops")
    for g, evs in by_group.items():
        commits = sorted(e["step"] for e in evs if e["event"] == "commit" and e["committed"])
        summaries = sorted(e["step"] for e in evs
                           if e["event"] == "step_summary" and e["committed"])
        if commits != summaries or len(commits) != results[g]["steps_run"]:
            raise AssertionError(f"group {g}: committed steps {commits} but step_summary "
                                 f"for {summaries} ({results[g]['steps_run']} steps run)")
        phases = {e["phase"] for e in evs if e["event"] == "span"}
        want = {"quorum", "allreduce_d2h", "allreduce_merge", "allreduce_h2d", "commit_vote",
                "heal" if g == 1 else "snapshot"}
        if not want <= phases:
            raise AssertionError(f"group {g}: spans {sorted(phases)} lack {sorted(want - phases)}")
        for step, st in results[g]["exchange_by_step"].items():
            got = {k: 0.0 for k in ("allreduce_d2h", "allreduce_merge", "allreduce_h2d")}
            for e in evs:
                if e["event"] == "span" and e["step"] == int(step) and e["phase"] in got:
                    got[e["phase"]] += e["duration_ms"]
            stats = {"allreduce_d2h": st["d2h_wait_s"], "allreduce_merge": st["ring_wait_s"],
                     "allreduce_h2d": st["h2d_s"]}
            diff = {k: got[k] - 1e3 * stats[k] for k in got}
            print(f"  group {g} step {step}: spans d2h / merge / h2d "
                  f"{got['allreduce_d2h']:.3f} / {got['allreduce_merge']:.3f} / "
                  f"{got['allreduce_h2d']:.3f} ms, last_stats "
                  f"{1e3 * stats['allreduce_d2h']:.3f} / {1e3 * stats['allreduce_merge']:.3f} / "
                  f"{1e3 * stats['allreduce_h2d']:.3f} ms", flush=True)
            if any(abs(d) > SPAN_TOL_MS for d in diff.values()):
                raise AssertionError(f"group {g} step {step}: span sums differ from last_stats "
                                     f"by {diff} ms (> {SPAN_TOL_MS})")
    problems = trace.validate_trace(trace.build_trace(sorted(events + hop_events,
                                                             key=lambda e: e["ts"])))
    if problems:
        raise AssertionError(f"the merged trace does not validate: {problems}")
    print(f"  trace of {len(events)} records + {len(hop_events)} hops: validates clean",
          flush=True)
    cols = ("quorum", "heal", "allreduce_d2h", "allreduce_merge", "allreduce_h2d",
            "commit_vote", "snapshot", "snapshot_wait")
    table = {}
    for g, evs in by_group.items():
        print(f"  group {g} per step, ms ({card}): step, wall, busy, " + ", ".join(cols),
              flush=True)
        rows = []
        for e in evs:
            if e["event"] != "step_summary":
                continue
            ph = e["phases"]
            row = {"step": e["step"], "committed": e["committed"],
                   "wall": e.get("step_wall_ms"), "busy": e.get("step_time_ms"),
                   **{c: ph.get(c, 0.0) for c in cols}}
            rows.append(row)
            print("    " + "  ".join(str(row[k]) for k in ("step", "wall", "busy", *cols)),
                  flush=True)
        table[g] = rows
        attribution = report.attribute(evs)
        print(f"  group {g}: obs.report.attribute", flush=True)
        report.render(attribution)
    plane = report.data_plane(events)
    links = report.link_attribution(events)
    print(f"  data_plane {json.dumps(plane)}", flush=True)
    print(f"  link_attribution (hop stall split) {json.dumps(links)}", flush=True)
    return {"steps": table, "data_plane": plane, "link_attribution": links}


# -- phase 6: kill and heal ---------------------------------------------------


def _ms(x) -> str:
    """A mean step time; None where the window held under two steps."""
    return "n/a (under two steps)" if x is None else f"{x:.2f} ms"


def kill_heal_phase(card: str) -> dict:
    from torchft_tpu_torch.examples.kill_heal import LOG_POLL_S, kill_and_heal

    # The floor of a restart: a bare process importing torch and reaching
    # the card.
    t0 = time.monotonic()
    subprocess.run([sys.executable, "-c", "import torch; torch.zeros(1, device='cuda')"],
                   check=True, timeout=300)
    cold_start_s = time.monotonic() - t0
    from torchft_tpu_torch.obs import report

    log_dir = tempfile.mkdtemp(prefix="tpuft_kill_")
    try:
        r = kill_and_heal("cuda", log_dir, steps=KILL_STEPS, merged_before_kill=KILL_MERGED,
                          timeout_s=KILL_TIMEOUT_S)
        events = report.read_events([r["metrics_path"]])
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    faults = report.fault_times(events)
    if [g for _, g in faults] != ["1"]:
        raise AssertionError(f"the stream's fault records name {faults}, expected one kill of 1")
    commits = report.commit_timelines(events)
    dw = report.deadwindow(commits, faults)
    if not dw["victims_recovered"] or dw["dead_time_s"] is None:
        raise AssertionError(f"the stream's dead window did not close: {dw}")
    # The stream's dead time is group 1's commit gap over the kill less one
    # median step; recovery_s ends at its first MERGED commit as a 20 ms log
    # poll reads it.  The gap starts at the last commit before the kill and
    # ends at the first commit after it (the heal step's).
    t_fault = faults[0][0]
    steps = sorted(commits["1"])
    k = next(i for i, t in enumerate(steps) if t > t_fault)
    merged = min(float(e["ts"]) for e in events
                 if e["event"] == "commit" and e["committed"] and e["participants"] == 2
                 and str(e["replica_id"]).startswith("1:") and float(e["ts"]) > t_fault)
    r["stream_dead_time_s"] = dw["dead_time_s"]
    r["stream_gap_s"] = steps[k] - steps[k - 1]
    r["stream_fault_to_first_commit_s"] = steps[k] - t_fault
    r["stream_fault_to_first_merged_commit_s"] = merged - t_fault
    print(f"  stream: fault record at the kill; obs.report.deadwindow dead time "
          f"{dw['dead_time_s']:.3f} s (group 1's commit gap {r['stream_gap_s']:.3f} s less a "
          f"median step; dead-window goodput fraction {dw['fraction']}) beside recovery_s "
          f"{r['recovery_s']:.3f} s: {dw['dead_time_s'] - r['recovery_s']:+.3f} s; fault -> "
          f"group 1's first commit {r['stream_fault_to_first_commit_s']:.3f} s, first merged "
          f"commit {merged - t_fault:.3f} s ({merged - t_fault - r['recovery_s']:+.3f} s "
          f"against recovery_s, which a {1e3 * LOG_POLL_S:.0f} ms log poll stamps) ({card})",
          flush=True)
    print(f"  restarts {r['restarts']}; both groups FINAL at step {r['final_step']} with "
          f"params_sha256 {r['params_sha256']}; {r['steps_logged']} finite losses", flush=True)
    print(f"  kill -> restarted group's first merged commit: {r['recovery_s']:.3f} s "
          f"(kill -> respawn {r['kill_to_restart_s']:.3f} s, -> heal line "
          f"{r['kill_to_heal_line_s']:.3f} s); survivor uncommitted steps "
          f"{r['survivor_uncommitted_steps']}; survivor step "
          f"{_ms(r['survivor_solo_step_ms'])} alone, {_ms(r['survivor_merged_step_ms'])} "
          f"merged ({card})", flush=True)
    print(f"  a bare process importing torch and reaching the card: {cold_start_s:.3f} s "
          f"({card})", flush=True)
    r["cold_start_s"] = cold_start_s
    print("KILL_HEAL " + json.dumps(r), flush=True)
    return r


# -- phase 7: the bare ring ---------------------------------------------------

# (engine, lanes, wire): the earlier port's ring, then the defaults, then the
# defaults on the bf16 wire.
BARE_RING_CONFIGS = (("py", 1, "f32"), ("native", 2, "f32"), ("native", 2, "bf16"))


def flagship_param_count() -> int:
    """Parameters of the flagship transformer: its gradient payload in
    float32 elements."""
    from torchft_tpu_torch.models import flagship_config

    cfg, _, _ = flagship_config()
    E, V, F, Dh = cfg.d_model, cfg.vocab_size, cfg.d_ff, cfg.d_head
    layer = 2 * E + E * cfg.n_heads * Dh * 2 + 2 * E * cfg.n_kv_heads * Dh + 3 * E * F
    return 2 * V * E + E + cfg.n_layers * layer


def bare_ring(card: str) -> dict:
    """Two in-process ranks allreduce the flagship's gradient payload over
    127.0.0.1 in each of BARE_RING_CONFIGS, each op on a fresh copy handed
    over with ``donate=True`` (as the averager hands its pinned buffers)."""
    import numpy as np

    from torchft_tpu_torch._native import StoreServer
    from torchft_tpu_torch.collectives import TCPCollective

    n = flagship_param_count()
    data = [np.random.default_rng(11 + r).standard_normal(n, dtype=np.float32) for r in range(2)]
    exact = data[0] + data[1]  # two addends: one IEEE sum, in any order
    store = StoreServer(bind="127.0.0.1:0")
    report = {"payload_bytes": 4 * n, "ops": {}}
    outs = {}
    try:
        for i, (engine, lanes, wire) in enumerate(BARE_RING_CONFIGS):
            cols = [TCPCollective(timeout=BARE_RING_TIMEOUT_S, wire_dtype=wire, lanes=lanes,
                                  engine=engine, host="127.0.0.1") for _ in range(2)]
            barrier = threading.Barrier(2)

            def rank(r: int, cols=cols, barrier=barrier, engine=engine, i=i):
                c = cols[r]
                c.configure(f"{store.address()}/bare/{i}", r, 2)
                if c.ring_engine != engine:
                    raise AssertionError(f"bare ring: asked for {engine}, ran {c.ring_engine}")
                secs, out = [], None
                for _ in range(BARE_RING_REPEATS):
                    buf = data[r].copy()
                    barrier.wait(timeout=BARE_RING_TIMEOUT_S)
                    t0 = time.perf_counter()
                    (out,) = c.allreduce([buf], donate=True).wait(timeout=BARE_RING_TIMEOUT_S)
                    secs.append(time.perf_counter() - t0)
                return secs, out

            try:
                with ThreadPoolExecutor(max_workers=2) as pool:
                    futs = [pool.submit(rank, r) for r in range(2)]
                    got = [f.result(timeout=2 * BARE_RING_TIMEOUT_S) for f in futs]
            finally:
                for c in cols:
                    c.shutdown()
            if got[0][1].view(np.uint32).tobytes() != got[1][1].view(np.uint32).tobytes():
                raise AssertionError(f"bare ring {engine}/{lanes}/{wire}: the ranks differ")
            secs = [max(a, b) for a, b in zip(got[0][0], got[1][0])]
            key = f"{engine}, {lanes} lane{'s' if lanes > 1 else ''}, {wire} wire"
            report["ops"][key] = {"s": secs, "gb_per_s": [4 * n / s / 1e9 for s in secs]}
            print(f"  {key}: " + ", ".join(f"{s:.3f} s ({4 * n / s / 1e9:.2f} GB/s)" for s in secs)
                  + f" for {4 * n / 1e6:.1f} MB of f32 ({card})", flush=True)
            if wire == "f32":
                outs[engine] = got[0][1]
                if not np.array_equal(got[0][1].view(np.uint32), exact.view(np.uint32)):
                    raise AssertionError(f"bare ring {key}: the sum is not a + b bit for bit")
            else:
                a, b = data
                if not (np.abs(got[0][1] - exact) <= 2.0 ** -7 * (np.abs(a) + np.abs(b))).all():
                    raise AssertionError(f"bare ring {key}: the sum is off by more than bf16 "
                                         f"rounding")
            del got
    finally:
        store.shutdown()
    same = np.array_equal(outs["py"].view(np.uint32), outs["native"].view(np.uint32))
    print(f"  py and native f32 results bitwise equal: {same}", flush=True)
    if not same:
        raise AssertionError("bare ring: the Python and native engines' f32 results differ")
    print("BARE_RING " + json.dumps(report), flush=True)
    return report


# -- phase 8: the raw-step profile ---------------------------------------------


def profile_phase(card: str) -> dict:
    """``tools/profile_step`` over PROFILE_STEPS chained flagship raw steps:
    fails without device events, and unless K1-K5 launch 12 / 12 / 12 / 1 /
    1 times a step."""
    from torchft_tpu_torch.models import flagship_config
    from torchft_tpu_torch.tools import profile_step

    cfg, _, _ = flagship_config()
    out_dir = tempfile.mkdtemp(prefix="tpuft_profile_")
    try:
        path = profile_step.capture(os.path.join(out_dir, "trace.json"), PROFILE_STEPS)
        rep = profile_step.build_report(path, PROFILE_STEPS)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if rep["device_total_ms_per_step"] is None:
        raise AssertionError(f"profile: {rep['device_absent']}")
    print(f"  {PROFILE_STEPS} chained full_steps: wall {rep['wall_ms_per_step']:.3f} ms/step, "
          f"device ops {rep['device_total_ms_per_step']:.3f} ms/step, device busy share "
          f"{rep['device_busy_share']}, {rep['device_events']} device events, "
          f"{rep['distinct_ops']} distinct ops ({card})", flush=True)
    for op in rep["ops"]:
        print(f"    {op['ms_per_step']:9.4f} ms/step {op['launches_per_step']:6.1f}/step "
              f"[{op['category']}] {op['name'][:100]}", flush=True)
    print("  by op class:", flush=True)
    for c in rep["by_class"]:
        print(f"    {c['ms_per_step']:9.4f} ms/step  {c['op_class']}", flush=True)
    want = {"flash_fwd_kernel": cfg.n_layers, "flash_bwd_dkdv_kernel": cfg.n_layers,
            "flash_bwd_dq_kernel": cfg.n_layers, "ce_lse_kernel": 1, "ce_dlogits_kernel": 1}
    got = {k: profile_step.launches_per_step(rep, k) for k in want}
    print(f"  K1-K5 launches a step in the trace: {got}", flush=True)
    if got != want:
        raise AssertionError(f"profile: kernel launches a step {got}, expected {want}")
    print("PROFILE " + json.dumps({k: v for k, v in rep.items() if k != "launches"}),
          flush=True)
    return rep


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--group", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--lighthouse", help=argparse.SUPPRESS)
    parser.add_argument("--run-dir", help=argparse.SUPPRESS)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from torchft_tpu_torch import _build
    from torchft_tpu_torch.ops import KERNELS

    if args.group is not None:
        run_group(args)
        return 0

    # 1. Card.
    card = nvidia_smi_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)", flush=True)

    # 2. Build: the native core and the kernels at the same time.
    t0 = time.monotonic()
    with ThreadPoolExecutor(max_workers=1) as pool:
        native = pool.submit(_build.native_lib_path)
        _build.build_kernels()
        native.result()
    print(f"build: {time.monotonic() - t0:.1f} s wall; " + ", ".join(
        f"{k} {v:.1f} s" for k, v in sorted(_build.build_seconds.items())), flush=True)
    for name, log in sorted(_build.build_logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)
    check_spills(_build.build_logs)

    # 3. Kernel checks.
    print("kernel checks (flagship shapes):", flush=True)
    rec = kernel_checks()

    # 4. The RMSNorm entry point.
    print("rms_norm_pallas entry point, flagship activations", flush=True)
    launches = {"rms_norm": rms_entry_point()["rms_norm"]}

    # 5. Flagship training.
    print("main path: lighthouse + 2 replica groups, flagship config", flush=True)
    main_launches, _ = main_path(card)
    launches.update(main_launches)
    missing = [n for n in KERNELS if launches.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"kernels never launched on their paths: {missing}")

    # 6. Kill and heal through the launcher and the train_ddp example.
    print("kill and heal: Launcher + train_ddp on the card, group 1 killed with SIGKILL",
          flush=True)
    kill_heal_phase(card)

    # 7. The bare ring on the card's host.
    print(f"bare ring: 2 in-process ranks, the flagship's gradient payload, "
          f"{BARE_RING_REPEATS} allreduces a configuration", flush=True)
    bare_ring(card)

    # 8. The raw-step profile.
    print(f"raw-step profile: torch.profiler over {PROFILE_STEPS} chained flagship full_steps",
          flush=True)
    profile_phase(card)

    # 9. The kernels line, then the last line.
    kernels = []
    for name, kern in KERNELS.items():
        r = rec[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"torchft_tpu_torch/csrc/{kern.source}.cu",
            "replaces": kern.replaces,
            "launches": launches[name],
            "launches_on": "rms_norm_pallas entry point" if name == "rms_norm"
                           else "flagship FT training",
            "max_abs_err": r["max_abs_err"],
            "ref_rms": r["ref_rms"],
            "err_over_tol": r["err_over_tol"],
            "tol": r["tol"],
            "planted_faults_err_over_tol": r["planted"],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("library_call", "library_bf16w_ms", "matmul_ms", "plain_call",
                                 "checked", "bitwise_repeat")
               if k in r},
        })
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
