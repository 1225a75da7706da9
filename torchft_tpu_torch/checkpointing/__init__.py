"""Checkpoints: the peer transports that heal a restarted group from a live
one (HTTP, and the collective's send/recv), and durable disk checkpoints
for a job that restarts cold.  Everything of the JAX package's
``checkpointing`` is ported."""

from torchft_tpu_torch.checkpointing.collective_transport import CollectiveTransport
from torchft_tpu_torch.checkpointing.disk import DiskCheckpointer, ManagedDiskCheckpoint
from torchft_tpu_torch.checkpointing.http_transport import HTTPTransport
from torchft_tpu_torch.checkpointing.transport import CheckpointTransport

__all__ = ["CheckpointTransport", "CollectiveTransport", "DiskCheckpointer", "HTTPTransport",
           "ManagedDiskCheckpoint"]
