"""RMSNorm with f32 statistics: the counterpart of
``torchft_tpu/ops/rmsnorm.py``.

- :func:`rms_norm`, the plain version the model uses (``rms_norm`` there).
- :func:`rms_norm_pallas`, the exported single-kernel op (``rms_norm_pallas``
  there): its forward is the hand-written Hopper kernel ``rms_norm``
  (``csrc/rmsnorm.cu``, the port of ``_rms_kernel``) on CUDA tensors and
  the plain ``_rms_reference`` on CPU tensors; its backward is the closed
  form of the JAX package's ``_rms_bwd`` in plain torch ops.
- :func:`rms_plan`, the kernel's path and ring for a shape (no card needed).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple

import torch

from torchft_tpu_torch.ops._launch import Kernel

RMS_NORM = Kernel(
    "rms_norm", "rmsnorm", "tf_rms_norm",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int],
    replaces="torchft_tpu/ops/rmsnorm.py:49",
)

# (x dtype, w dtype) pairs the kernel is built for: the flagship's bf16
# activations with f32 params, and f32 throughout.
_PAIRS = ((torch.bfloat16, torch.float32), (torch.float32, torch.float32))

# The kernel's element-wise tolerance against ``_rms_reference`` on the
# card, |got - ref| <= rtol |ref| + row x rms(ref's row) + atol (the form of
# chip_smoke.py's checks; tools/ab_rms_norm.py uses the same).  One rounding
# of an f32 result on each side; results that differ in the last f32 bits
# (rsqrtf, the shuffle-tree sum) can round one bf16 step apart, up to 2^-7
# of the value just above a power of two, so 1.6e-2 |ref| allows two
# steps; f32 outputs 1e-5 |ref|.
TOL_RMS = {"rtol": 1.6e-2, "row": 0.0, "atol": 1e-5}
TOL_RMS_F32 = {"rtol": 1e-5, "row": 0.0, "atol": 1e-6}

# The rings' sizes, as csrc/rmsnorm.cu lays out its shared memory.
TILE_BYTES = 4096         # the most bytes of x one tile (rows_per_tile whole rows) holds, R > 1
MAX_ROWS_PER_TILE = 16
SMEM_PER_BLOCK = 232448   # dynamic shared memory a block may opt in to
SMEM_PER_SM = 233472      # an SM's shared memory; each resident block reserves 1 KB more
_HEAD_BYTES = 640         # the rings' mbarriers and partial sums
_WARPS = 8                # 256 threads a block
_MAX_STAGES = 4
# Blocks an SM the kernel's registers allow, by the 16-byte vectors of a
# row each lane keeps in registers (its ptxas report: 62-64 registers up to
# 6 vectors, 79 at 8).
_REG_BLOCKS = {4: 4, 6: 4, 8: 3}


class RmsPlan(NamedTuple):
    """How the kernel runs one shape.

    ``path``: ``"tma"`` (the row rings: bulk copies into shared memory,
    each byte of x read from device memory once), ``"vector"`` (an aligned
    row too wide for a ring of two: one warp a row from device memory) or
    ``"scalar"`` (a row that is not a multiple of 16 bytes); the kernel
    takes the last two from ``stages`` 0 and the row's alignment.  On the
    ring, each group of ``warps_per_row`` warps owns a ring of ``stages``
    slots of ``rows_per_tile`` rows and reduces each row together;
    ``smem_bytes`` is a block's shared memory (0 off the ring; the kernel
    works it out again from the other fields) and ``blocks`` the grid."""

    path: str
    rows_per_tile: int
    stages: int
    smem_bytes: int
    blocks: int
    warps_per_row: int


@functools.lru_cache(maxsize=512)
def rms_plan(rows: int, d: int, dtype: torch.dtype, sms: int = 132) -> RmsPlan:
    """The kernel's path for x [rows, d] of ``dtype`` on a card with ``sms``
    SMs, chosen from the shape alone.

    On the ring: the fewest warps a row (1, 2, 4, 8) whose lanes hold the
    row in 8 registers' vectors each; rows_per_tile the largest power of
    two up to 16 whose rows fit in TILE_BYTES (one row where a row is
    wider); then the most blocks an SM the registers allow at which 2
    stages (tiles up to 3 KB, or rows shared by several warps) or 3 fit
    the SM's shared memory (with a copy of w for bf16 rows), with as many
    stages as fit there, up to 4; no more blocks than the groups' tiles
    need.  PERF.md gives each choice against its alternatives on the
    card (tools/ab_rms_norm.py)."""
    row = d * dtype.itemsize
    scalar = RmsPlan("scalar", 0, 0, 0, -(-rows // _WARPS), 1)
    if row % 16:
        return scalar
    nv = d // (16 // dtype.itemsize)
    gw = next((g for g in (1, 2, 4) if nv <= 8 * 32 * g), 8)
    per_lane = -(-nv // (32 * gw))
    cache = 4 if per_lane <= 4 else 6 if per_lane <= 6 else 8
    rt = MAX_ROWS_PER_TILE
    while rt > 1 and rt * row > TILE_BYTES:
        rt //= 2
    groups = _WARPS // gw
    # bf16 rows keep a copy of w in shared memory; f32 rows read it through L1.
    fixed = _HEAD_BYTES + (-(-d * 4 // 128) * 128 if dtype == torch.bfloat16 else 0)
    ring = groups * rt * row  # one stage of every group's ring
    for per_sm in range(_REG_BLOCKS[cache], 0, -1):
        stages = min(_MAX_STAGES, (SMEM_PER_SM // per_sm - 1024 - fixed) // ring)
        if stages >= (2 if rt * row <= 3072 or gw > 1 else 3):
            break
    if stages < 2:
        return scalar._replace(path="vector")
    blocks = min(sms * per_sm, -(-rows // (rt * groups)))
    return RmsPlan("tma", rt, stages, fixed + stages * ring, blocks, gw)


_SMS: Dict[int, int] = {}


def _sms(device: torch.device) -> int:
    """The SM count of a card, asked once."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, statistics in
    f32 whatever the input dtype; differentiable by autograd."""
    xf = x.float()
    inv = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * w.float()).to(x.dtype)


def _rms_reference(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The math of ``_rms_kernel`` on tensors: f32 statistics and scaling,
    one rounding to x's dtype."""
    return rms_norm(x, w, eps)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raises unless (x, w) is what the kernel takes: a dtype pair of
    ``_PAIRS``, x [rows, d] and w [d], contiguous, 16-byte aligned, on one
    card."""
    if (x.dtype, w.dtype) not in _PAIRS:
        raise TypeError(f"rms_norm: no kernel for x {x.dtype} with w {w.dtype}; "
                        f"supported pairs: {_PAIRS}")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"rms_norm: x and w must be on one CUDA device, got {x.device} and "
                         f"{w.device}")
    if x.dim() != 2 or w.shape != (x.shape[1],) or x.shape[1] == 0:
        raise ValueError(f"rms_norm: expected x [rows, d] and w [d] with d > 0, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rms_norm: inputs must be contiguous")
    if (x.data_ptr() | w.data_ptr()) % 16:
        raise ValueError("rms_norm: inputs must be 16-byte aligned")


def rms_fwd(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward of ``rms_norm_pallas`` on x [rows, d]: the kernel on a CUDA
    tensor (the path ``rms_plan`` picks), the plain version on a CPU
    tensor."""
    if x.device.type == "cpu":
        return _rms_reference(x, w, eps)
    _check(x, w)
    rows, d = x.shape
    out = torch.empty_like(x)
    if rows:
        p = rms_plan(rows, d, x.dtype, _sms(x.device))
        RMS_NORM(x.data_ptr(), w.data_ptr(), out.data_ptr(), rows, d, eps,
                 x.dtype == torch.bfloat16, p.rows_per_tile, p.stages, p.warps_per_row,
                 p.blocks)
    return out


def _rms_bwd(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor, eps: float):
    """Closed-form (dx, dw) of ``_rms_bwd`` (``torchft_tpu/ops/rmsnorm.py:97``)
    in f32; dx in x's dtype, dw in w's."""
    xf, gf, wf = x.float(), g.float(), w.float()
    inv = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    xhat = xf * inv
    gw = gf * wf
    dx = inv * (gw - xhat * (gw * xhat).mean(dim=-1, keepdim=True))
    dw = (gf * xhat).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dw.to(w.dtype)


class _RMSNormPallas(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        d = x.shape[-1]
        return rms_fwd(x.contiguous().reshape(-1, d), w.contiguous(), eps).reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _rms_bwd(x, w, g, ctx.eps)
        return dx, dw, None


def rms_norm_pallas(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm as one kernel launch on the card, over x's last axis, every
    leading axis flattened to rows (a 1-D x is one row).  On CUDA, x is bf16
    or f32 and w is f32; on the CPU any float dtypes take the plain version.

    The backward is plain torch in f32, as the JAX package's custom VJP is
    plain XLA: the TPU package has no backward kernel to port."""
    return _RMSNormPallas.apply(x, w, eps)
