from torchft_tpu_torch.models.convnet import ConvNet, convnet_loss
from torchft_tpu_torch.models.moe import moe_capacity, moe_ffn
from torchft_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    flagship_config,
    loss_fn,
    param_axes,
    parallelize,
    resolve_device,
    token_cross_entropy,
    vocab_parallel_cross_entropy,
)

__all__ = [
    "ConvNet",
    "Transformer",
    "TransformerConfig",
    "convnet_loss",
    "flagship_config",
    "loss_fn",
    "moe_capacity",
    "moe_ffn",
    "param_axes",
    "parallelize",
    "resolve_device",
    "token_cross_entropy",
    "vocab_parallel_cross_entropy",
]
