"""Commit-gated optimizer wrapper.

The counterpart of ``torchft_tpu/optim.py``: ``zero_grad`` starts the step's
quorum, and ``step`` runs the wrapped ``torch.optim.Optimizer`` only when
the Manager's commit vote passes.  The parameters are updated in place, so
they always hold the last committed values.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from torchft_tpu_torch.manager import Manager


class Optimizer:
    """Wraps ``optimizer`` so that its step is gated on ``should_commit``."""

    def __init__(self, manager: Manager, optimizer: torch.optim.Optimizer) -> None:
        self.manager = manager
        self.optim = optimizer

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Starts the quorum for this step, then clears the gradients."""
        self.manager.start_quorum()
        self.optim.zero_grad(set_to_none=set_to_none)

    def step(self) -> bool:
        """Applies the gradients iff the commit vote passes; returns whether
        the update landed."""
        if not self.manager.should_commit():
            return False
        self.optim.step()
        return True

    def state_dict(self) -> Dict[str, Any]:
        return self.optim.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.optim.load_state_dict(state)
