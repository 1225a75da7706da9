"""TrainStep: one model's training step, plain or fault-tolerant.

The counterpart of ``torchft_tpu/parallel/trainer.py`` (non-overlapped):

  - ``full_step``: loss -> grads -> optimizer step, no cross-group traffic;
  - ``grads`` / ``apply``: the split form for fault-tolerant training, so
    the Manager's cross-group gradient average runs between them;
  - ``ft_step``: grads -> ``GradientAverager`` -> ``should_commit`` ->
    optimizer step only if the vote passed.

PyTorch updates parameters and optimizer state in place, so the step returns
only the loss (and the commit decision).  A step on which the Manager healed
has already installed the fetched state through its ``load_state_dict``
callback when ``should_commit`` returns; the optimizer step then applies
the averaged gradients to that state, exactly as the donor does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from torchft_tpu_torch.ddp import GradientAverager
from torchft_tpu_torch.manager import Manager


@dataclasses.dataclass
class TrainStep:
    """Args:
        model: the module whose parameters train.
        optimizer: a ``torch.optim.Optimizer`` over ``model``'s parameters.
        loss_fn: (model, batch) -> scalar loss.
        manager: the group's Manager (needed by ``ft_step`` only).
    """

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor]
    manager: Optional[Manager] = None

    def __post_init__(self) -> None:
        self._averager: Optional[GradientAverager] = None

    @property
    def averager(self) -> Optional[GradientAverager]:
        """The gradient averager of ``ft_step`` (its ``last_stats`` split the
        last exchange), or None before the first fault-tolerant step."""
        return self._averager

    def grads(self, batch: Any) -> torch.Tensor:
        """Forward and backward; leaves the gradients in ``param.grad``."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(self.model, batch)
        loss.backward()
        return loss.detach()

    def apply(self) -> None:
        self.optimizer.step()

    def full_step(self, batch: Any) -> torch.Tensor:
        """Loss, grads and update with no cross-group averaging."""
        loss = self.grads(batch)
        self.apply()
        return loss

    def ft_step(self, batch: Any) -> Tuple[torch.Tensor, bool]:
        """One fault-tolerant step: local grads -> cross-group average ->
        commit vote -> update.  Returns (loss, committed).  The caller has
        called ``manager.start_quorum()`` for this step."""
        manager = self.manager
        if manager is None:
            raise ValueError("ft_step needs a TrainStep with a manager")
        if self._averager is None or self._averager.manager is not manager:
            self._averager = GradientAverager(manager)
        loss = self.grads(batch)
        params = [p for p in self.model.parameters() if p.requires_grad]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._averager.allreduce([p.grad for p in params])
        committed = manager.should_commit()
        if committed:
            self.apply()
        return loss, committed
