"""Cooperative drain: a planned departure handed off instead of crashed.

The counterpart of ``torchft_tpu/drain``.  Most departures are announced
(a SIGTERM grace period, a cloud maintenance or preemption notice, an
operator's request), so the departing group can finish its step and leave
with no survivor failing a commit:

  1. :class:`DrainWatcher` turns SIGTERM, the notice file
     (``TPUFT_DRAIN_DIR``/``drain_<group>.json``), the opt-in GCE metadata
     poll or an explicit :meth:`DrainWatcher.trigger` into one
     :class:`DrainNotice` with a deadline.
  2. The :class:`~torchft_tpu_torch.manager.Manager` (``begin_drain``)
     tells the lighthouse at once (wire method 5), so the next quorum
     leaves the group out; the train loop finishes the step in flight,
     votes, and exits through ``complete_drain``.
  3. The supervisor (:meth:`torchft_tpu_torch.launch.Launcher.drain`)
     hands the group's id to a replacement (a hot spare when one is
     ready) at notice time, so its start overlaps the donor's last step.

Observability: ``drain_notice``, ``drain_handoff``, ``drain_donor_exit``
and ``drain_complete`` events in the metrics stream.
"""

from torchft_tpu_torch.drain.watcher import (
    DRAIN_DIR_ENV,
    DRAIN_GRACE_ENV,
    GCE_METADATA_URL_ENV,
    GCE_POLL_ENV,
    DrainNotice,
    DrainWatcher,
)

__all__ = [
    "DRAIN_DIR_ENV",
    "DRAIN_GRACE_ENV",
    "GCE_METADATA_URL_ENV",
    "GCE_POLL_ENV",
    "DrainNotice",
    "DrainWatcher",
]
