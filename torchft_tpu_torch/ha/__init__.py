"""High-availability primitives of the port: the decorrelated-jitter
backoff that paces the Manager's heal retries (``torchft_tpu/ha/``'s
``backoff.py``; the lease and the replicated lighthouse are not ported)."""

from torchft_tpu_torch.ha.backoff import DecorrelatedBackoff

__all__ = ["DecorrelatedBackoff"]
