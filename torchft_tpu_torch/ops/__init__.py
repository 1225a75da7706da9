"""Hot ops of the model: hand-written Hopper kernels for CUDA tensors, plain
PyTorch for CPU tensors."""

from torchft_tpu_torch.ops._launch import KERNELS, launch_counts, reset_launch_counts
from torchft_tpu_torch.ops.attention import flash_attention
from torchft_tpu_torch.ops.cross_entropy import fused_linear_cross_entropy
from torchft_tpu_torch.ops.rmsnorm import rms_norm, rms_norm_pallas

__all__ = [
    "KERNELS",
    "flash_attention",
    "fused_linear_cross_entropy",
    "launch_counts",
    "reset_launch_counts",
    "rms_norm",
    "rms_norm_pallas",
]
