"""Checkpoint transport abstraction for live peer-to-peer weight recovery.

The counterpart of ``torchft_tpu/checkpointing/transport.py``: a transport
moves a full state dict from a healthy replica group to a recovering one
while the healthy groups keep training.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, List, Sequence, Union


class CheckpointTransport(ABC):
    # True for pull-based transports whose serving is passive: the Manager
    # then opens the window for every recovering group.
    serves_all_donors: bool = False

    @abstractmethod
    def metadata(self) -> str:
        """Transport address relayed to recovering peers by the quorum."""

    @abstractmethod
    def send_checkpoint(self, dst_ranks: List[int], step: int, state_dict: Any, timeout: float) -> None:
        """Makes ``state_dict`` for ``step`` available to ``dst_ranks``."""

    def disallow_checkpoint(self) -> None:
        """Called before the weights change (the optimizer step)."""

    @abstractmethod
    def recv_checkpoint(
        self, src_rank: int, metadata: Union[str, Sequence[str]], step: int, timeout: float
    ) -> Any:
        """Fetches the state dict for ``step`` from the donor at ``metadata``
        (a donor list is accepted; this slice uses its first entry)."""

    def shutdown(self, wait: bool = True) -> None:
        """Releases transport resources."""
