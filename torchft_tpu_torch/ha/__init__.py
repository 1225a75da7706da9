"""Highly-available lighthouse of the port: warm standbys behind a lease.

The port of ``torchft_tpu/ha/``, whole:

- :mod:`~torchft_tpu_torch.ha.lease`: leader election as a lease in a
  shared file (atomic-rename writes, settle-and-confirm acquisition; the
  native server's serve-time guard), the JAX package's record byte for
  byte, so JAX and port replicas can share one lease file;
- :mod:`~torchft_tpu_torch.ha.replica`: :class:`HALighthouse`, one replica
  of the group: the native lighthouse, the election loop and the leader's
  continuous replication to the standbys (membership, the sentinels'
  health, alerts, the previous quorum and its id), so a takeover resumes
  quorum formation on the fast path with the quorum id unchanged;
- :mod:`~torchft_tpu_torch.ha.backoff`: decorrelated-jitter retry pacing
  for every lighthouse reconnect loop (and the Manager's heal retries), so
  replica groups failing over at one instant do not stampede the new
  leader.

Run replicas with ``python -m torchft_tpu_torch.lighthouse_cli --lease-file
/shared/lease --peers a:1,b:1 ...`` and point clients at the whole set:
``TPUFT_LIGHTHOUSE=host1:29510,host2:29510``.  The native manager and the
port's :class:`~torchft_tpu_torch._native.LighthouseClient` fail over and
follow redirects.
"""

from torchft_tpu_torch.ha.backoff import DecorrelatedBackoff
from torchft_tpu_torch.ha.lease import FileLease, LeaseRecord

__all__ = ["DecorrelatedBackoff", "FileLease", "LeaseRecord", "HALighthouse"]


def __getattr__(name: str):
    # HALighthouse loads the native library (built at first use); keep that
    # out of `import torchft_tpu_torch.ha` for the lease and backoff alone.
    if name == "HALighthouse":
        from torchft_tpu_torch.ha.replica import HALighthouse

        return HALighthouse
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
