"""RMSNorm with f32 statistics: the counterpart of
``torchft_tpu/ops/rmsnorm.py:rms_norm``, the plain version the model uses.
(The TPU kernel ``_rms_kernel`` is off the model's path and not yet
ported.)"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last axis, statistics in
    f32 whatever the input dtype; differentiable by autograd."""
    xf = x.float()
    inv = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * inv * w.float()).to(x.dtype)
