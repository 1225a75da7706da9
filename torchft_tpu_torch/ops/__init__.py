"""Hot ops of the model: hand-written Hopper kernels for CUDA tensors, plain
PyTorch for CPU tensors, and the shape gates that pick between them."""

from torchft_tpu_torch.ops._launch import KERNELS, launch_counts, reset_launch_counts
from torchft_tpu_torch.ops.attention import flash_applicable, flash_attention, plain_attention
from torchft_tpu_torch.ops.cross_entropy import fused_ce_applicable, fused_linear_cross_entropy
from torchft_tpu_torch.ops.rmsnorm import rms_norm, rms_norm_pallas

__all__ = [
    "KERNELS",
    "flash_applicable",
    "flash_attention",
    "fused_ce_applicable",
    "fused_linear_cross_entropy",
    "launch_counts",
    "plain_attention",
    "reset_launch_counts",
    "rms_norm",
    "rms_norm_pallas",
]
