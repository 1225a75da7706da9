from torchft_tpu_torch.models.transformer import (
    Transformer,
    TransformerConfig,
    flagship_config,
    loss_fn,
    resolve_device,
    token_cross_entropy,
)

__all__ = [
    "Transformer",
    "TransformerConfig",
    "flagship_config",
    "loss_fn",
    "resolve_device",
    "token_cross_entropy",
]
