"""RMSNorm with f32 statistics: the counterpart of
``torchft_tpu/ops/rmsnorm.py``.

- :func:`rms_norm`, the plain version the model uses (``rms_norm`` there).
- :func:`rms_norm_pallas`, the exported single-kernel op (``rms_norm_pallas``
  there): its forward is the hand-written Hopper kernel ``rms_norm``
  (``csrc/rmsnorm.cu``, the port of ``_rms_kernel``) on CUDA tensors and
  the plain ``_rms_reference`` on CPU tensors; its backward is the closed
  form of the JAX package's ``_rms_bwd`` in plain torch ops.
"""

from __future__ import annotations

import ctypes

import torch

from torchft_tpu_torch.ops._launch import Kernel, check_cuda

RMS_NORM = Kernel(
    "rms_norm", "rmsnorm", "tf_rms_norm",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_float, ctypes.c_int],
    replaces="torchft_tpu/ops/rmsnorm.py:49",
)

# (x dtype, w dtype) pairs the kernel is built for: the flagship's bf16
# activations with f32 params, and f32 throughout.
_PAIRS = ((torch.bfloat16, torch.float32), (torch.float32, torch.float32))


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
    ``_PAIRS``, x [rows, d] and w [d], contiguous, aligned, on one card."""
    if (x.dtype, w.dtype) not in _PAIRS:
        raise TypeError(f"rms_norm: no kernel for x {x.dtype} with w {w.dtype}; "
                        f"supported pairs: {_PAIRS}")
    check_cuda("rms_norm", x.dtype, x)
    check_cuda("rms_norm", torch.float32, w)
    if w.device != x.device:
        raise ValueError("rms_norm: x and w must be on one CUDA device")
    if x.dim() != 2 or w.shape != (x.shape[1],) or x.shape[1] == 0:
        raise ValueError(f"rms_norm: expected x [rows, d] and w [d] with d > 0, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def rms_fwd(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward of ``rms_norm_pallas`` on x [rows, d]: the kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return _rms_reference(x, w, eps)
    _check(x, w)
    out = torch.empty_like(x)
    if x.shape[0]:
        RMS_NORM(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1], eps,
                 int(x.dtype == torch.bfloat16))
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
