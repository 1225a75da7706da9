"""Lease-based leader election over a shared file.

The lighthouse HA group needs exactly one leader and needs it without a
consensus protocol: a lease in a shared file (one local file system, or
NFS / GCS-fuse / a PVC in a real deployment) is the entire election
substrate.  This is the JAX package's protocol (``torchft_tpu/ha/lease.py``)
and its on-disk record byte for byte, so JAX and port replicas can share
one lease file.

Protocol (all writes are atomic tmp + ``os.replace``):

- The lease file holds one record: ``epoch``, ``owner``, the owner's RPC
  and HTTP addresses, and ``expires_ms`` (epoch milliseconds).
- **Renewal** (leader, every ~lease/3): re-read first — if the file no
  longer names this owner at this epoch, the lease was taken (e.g. this
  process stalled past expiry and a rival won): return ``None`` and the
  caller must demote *immediately*.  Otherwise rewrite with a fresh
  expiry.
- **Acquisition** (candidate, when the record is missing or expired):
  write a candidacy record with ``epoch + 1``, sleep a short *settle*
  delay (jittered — two candidates racing must not re-read in lockstep),
  then re-read: whoever's record survived the race is leader; the loser
  reads the winner's record and follows.  Converges on exactly one leader
  because ``os.replace`` is atomic and last-writer-wins: after the settle
  window only one record exists, and every candidate judges itself against
  that one record.
- **Serve-time guard** (not in this file): holding the lease only matters
  while it is unexpired — the native lighthouse refuses authoritative
  answers once ``expires_ms`` passes without a renewal, which closes the
  stalled-leader window the file protocol alone cannot.

Clock discipline: expiries compare wall clocks across processes, so the
protocol assumes hosts are synced to well under the lease duration (the
same assumption the heartbeat timeout already makes).  ``clock`` is
injectable for boundary tests.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Callable, Optional

__all__ = ["LeaseRecord", "FileLease"]


@dataclass
class LeaseRecord:
    """One parsed lease-file record."""

    epoch: int
    owner: str
    rpc_address: str
    http_address: str
    expires_ms: int

    def expired(self, now_ms: int) -> bool:
        return now_ms >= self.expires_ms


class FileLease:
    """One participant's view of the shared lease file.

    Args:
        path: the shared lease file (its directory must exist).
        lease_ms: lease duration; a leader that cannot renew within this
            window loses leadership.  The failover floor: a standby can
            take over at most one lease period after the leader dies.
        owner_id: unique id of this participant (e.g. ``host:port`` of its
            RPC server).
        clock: seconds-since-epoch callable (injectable for tests).
        sleep: sleep callable (injectable for tests).
        settle_s: candidacy settle delay before the confirm re-read;
            defaults to min(150 ms, lease/4) plus up to 50% jitter.
    """

    def __init__(
        self,
        path: str,
        lease_ms: int,
        owner_id: str,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
        settle_s: Optional[float] = None,
        rng: Optional[random.Random] = None,
    ) -> None:
        if lease_ms <= 0:
            raise ValueError("lease_ms must be > 0")
        self.path = path
        self.lease_ms = int(lease_ms)
        self.owner_id = owner_id
        self._clock = clock
        self._sleep = sleep
        self._settle_s = settle_s
        self._rng = rng or random.Random()

    # -- record I/O ---------------------------------------------------------

    def _now_ms(self) -> int:
        return int(self._clock() * 1000)

    def _settle_floor_ms(self) -> int:
        """The un-jittered settle minimum — the stall budget a candidate's
        read->write gap must stay under for settle-and-confirm to cover
        it (see try_acquire)."""
        settle = self._settle_s
        if settle is None:
            settle = min(0.15, self.lease_ms / 1000.0 / 4.0)
        # At least one wall-clock tick so an explicit settle_s=0 (boundary
        # tests with fake clocks) never self-aborts on rounding.
        return max(1, int(settle * 1000))

    def read(self) -> Optional[LeaseRecord]:
        """The current record, or None when missing/corrupt (a torn write
        cannot happen — writes are atomic replaces — but a manually
        truncated or garbage file must read as 'no lease', not crash the
        election)."""
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                lines = f.read().splitlines()
        except OSError:
            return None
        if len(lines) < 5:
            return None
        try:
            return LeaseRecord(
                epoch=int(lines[0]),
                owner=lines[1],
                rpc_address=lines[2],
                http_address=lines[3],
                expires_ms=int(lines[4]),
            )
        except ValueError:
            return None

    def _write(self, rec: LeaseRecord) -> None:
        tmp = f"{self.path}.{self.owner_id.replace('/', '_').replace(':', '_')}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(
                f"{rec.epoch}\n{rec.owner}\n{rec.rpc_address}\n"
                f"{rec.http_address}\n{rec.expires_ms}\n"
            )
        os.replace(tmp, self.path)  # atomic: readers see whole records

    # -- protocol -----------------------------------------------------------

    def try_acquire(
        self, rpc_address: str, http_address: str
    ) -> Optional[LeaseRecord]:
        """One acquisition attempt.  Returns the record this participant
        now leads under, or None (a live lease exists, or a rival won the
        race).  Call only when :meth:`read` shows no live lease — calling
        against a live lease is a no-op returning None."""
        now = self._now_ms()
        current = self.read()
        if current is not None and not current.expired(now):
            return None
        candidacy = LeaseRecord(
            epoch=(current.epoch if current else 0) + 1,
            owner=self.owner_id,
            rpc_address=rpc_address,
            http_address=http_address,
            expires_ms=now + self.lease_ms,
        )
        # Stall guard: the settle-and-confirm window only covers candidates
        # whose expired-read -> candidacy-write delay is under the settle
        # minimum — a rival that read before OUR write and writes after OUR
        # confirm must have stalled at least one settle period in between
        # (GC pause, frozen VM, slow shared FS).  Abort this attempt when
        # we ARE that stalled candidate: a late write here would overwrite
        # a rival's already-confirmed lease at the same epoch and dual-serve
        # until its next renewal.  (The residual race — a stall landing
        # between this check and the rename — is the irreducible cost of a
        # CAS-free file protocol; this shrinks it from arbitrary to tiny.)
        if self._now_ms() - now > self._settle_floor_ms():
            return None
        self._write(candidacy)
        # Settle: let the other candidates' writes land, then judge against
        # the one surviving record.  Jittered so racing candidates do not
        # re-read in lockstep (and so back-to-back retries decorrelate).
        settle = self._settle_s
        if settle is None:
            settle = min(0.15, self.lease_ms / 1000.0 / 4.0)
        self._sleep(settle * (1.0 + 0.5 * self._rng.random()))
        after = self.read()
        if (
            after is not None
            and after.owner == self.owner_id
            and after.epoch == candidacy.epoch
        ):
            # Won the race.  The settle delay ate into the lease; the
            # expiry stands as written (renewal extends it immediately).
            return after
        return None  # lost: `after` names the winner to follow

    def renew(self, held: LeaseRecord) -> Optional[LeaseRecord]:
        """Extends a held lease.  Returns the renewed record, or None when
        the lease was lost — the file no longer names this owner/epoch
        (stolen after an expiry we slept through), or the lease already
        expired (renewing an expired lease would race a candidate's
        acquisition; the holder must demote and re-acquire instead)."""
        now = self._now_ms()
        current = self.read()
        if (
            current is None
            or current.owner != self.owner_id
            or current.epoch != held.epoch
        ):
            return None  # stolen (or deleted): demote immediately
        if current.expired(now):
            return None  # lapsed: a candidate may be mid-acquisition
        if self._now_ms() - now > self._settle_floor_ms():
            # Stalled between the read and the write (same hole as in
            # try_acquire): the lease may have lapsed and been taken during
            # the stall — a late rewrite would clobber the new holder's
            # record with THIS stale epoch.  Demote instead.
            return None
        renewed = LeaseRecord(
            epoch=held.epoch,
            owner=self.owner_id,
            rpc_address=held.rpc_address,
            http_address=held.http_address,
            expires_ms=now + self.lease_ms,
        )
        self._write(renewed)
        return renewed

    def release(self, held: LeaseRecord) -> None:
        """Clean handoff on shutdown: expire the held lease NOW so a
        standby takes over without waiting out the remaining lease.  A
        no-op when the lease is no longer ours."""
        current = self.read()
        if (
            current is None
            or current.owner != self.owner_id
            or current.epoch != held.epoch
        ):
            return
        expired = LeaseRecord(
            epoch=held.epoch,
            owner=self.owner_id,
            rpc_address=held.rpc_address,
            http_address=held.http_address,
            expires_ms=self._now_ms(),
        )
        self._write(expired)
