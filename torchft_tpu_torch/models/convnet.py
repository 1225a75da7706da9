"""Small conv net on 32x32x3 inputs: the train_ddp example's model.

The counterpart of ``torchft_tpu/models/convnet.py`` with its math exactly:
a 3x3 stride-2 convolution to 16 channels without bias, ReLU, a 4096 -> 64
dense layer with ReLU, and a 64 -> n_classes dense layer.  Inputs stay NHWC
``[B, 32, 32, 3]`` float32 as in the JAX package; two layout points follow
it:

- ``padding="SAME"`` at stride 2 pads 32 -> 33 rows and columns, all of it
  AFTER the image (XLA puts the odd pad element on the high side), so the
  port pads (0, 1) explicitly and convolves without padding
  (``nn.Conv2d(padding=1)`` would pad both sides and shift every window);
- the flatten runs over NHWC, so ``w1``'s 4096 inputs are in (h, w, c)
  order; the activations are permuted back to NHWC before it.

Parameters keep the JAX names (``conv``, ``w1``, ``b1``, ``w2``, ``b2``) in
PyTorch's layouts: ``conv`` OIHW, ``w1`` and ``w2`` ``[out, in]`` as
``F.linear`` takes them.  The model has no TPU kernel: its ops are cuDNN's
convolution and plain matrix products on the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from torchft_tpu_torch.models.transformer import resolve_device


class ConvNet(nn.Module):
    """The example's CIFAR-shaped classifier; weights are drawn as the JAX
    ``init_convnet_params`` draws them (normal x 0.1 for the convolution,
    x 0.02 for the dense layers, zero biases) from ``generator``."""

    def __init__(
        self,
        n_classes: int = 10,
        device: Union[str, torch.device, None] = None,
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator(device=device).manual_seed(0)

        def normal(shape, std: float) -> nn.Parameter:
            return nn.Parameter(torch.randn(shape, generator=gen, device=device) * std)

        self.conv = normal((16, 3, 3, 3), 0.1)
        self.w1 = normal((64, 16 * 16 * 16), 0.02)
        self.b1 = nn.Parameter(torch.zeros(64, device=device))
        self.w2 = normal((n_classes, 64), 0.02)
        self.b2 = nn.Parameter(torch.zeros(n_classes, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, 32, 32, 3] (NHWC) -> logits [B, n_classes]."""
        h = F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1))  # SAME at stride 2: (0, 1)
        h = F.relu(F.conv2d(h, self.conv, stride=2))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)  # (h, w, c) order
        h = F.relu(F.linear(h, self.w1, self.b1))
        return F.linear(h, self.w2, self.b2)


def convnet_loss(model: ConvNet, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of the logits against integer labels."""
    return F.cross_entropy(model(x), y.long())
