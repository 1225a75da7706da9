"""torchft_tpu_torch — the PyTorch/CUDA port of tpu-ft.

Per-step fault tolerance for PyTorch training on NVIDIA Hopper: a Manager
that forms a quorum of replica groups every step, averages gradients across
them over a reconfigurable TCP ring, heals a group that fell behind from a
healthy peer over HTTP, and gates every optimizer step on a commit vote.
The model's hot ops run as hand-written CUDA kernels for ``sm_90a``.

The JAX package ``torchft_tpu`` is the reference; this package imports
nothing of it, and speaks the same wire to the same native coordination
core (``native/``).
"""

from torchft_tpu_torch.collectives import (
    Collective,
    DummyCollective,
    ErrorSwallowingCollective,
    ManagedCollective,
    TCPCollective,
)
from torchft_tpu_torch.ddp import GradientAverager
from torchft_tpu_torch.manager import Manager
from torchft_tpu_torch.optim import Optimizer

__all__ = [
    "Collective",
    "DummyCollective",
    "ErrorSwallowingCollective",
    "GradientAverager",
    "ManagedCollective",
    "Manager",
    "Optimizer",
    "TCPCollective",
]
