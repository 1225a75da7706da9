"""One lighthouse replica of a highly-available lighthouse group.

``HALighthouse`` wraps the native :class:`~torchft_tpu_torch._native.LighthouseServer`
with the two loops that turn N independent processes into one logical
service (the JAX package's ``torchft_tpu/ha/replica.py``, on the same lease
file format and the same wire, so JAX and port replicas form one group):

- **election**: a lease in a shared file
  (:class:`torchft_tpu_torch.ha.lease.FileLease`).  The leader renews at
  about lease/3 and pushes the renewed expiry into the native server, whose
  serve-time guard refuses Quorum and Heartbeat once the expiry passes, so
  a stalled renewal thread cannot leave a zombie leader answering; a
  follower polls the file and takes over once the lease expires, at the
  next epoch;
- **replication**: on its own thread, the leader serializes the whole
  lighthouse state (membership, live step and state, the straggler
  sentinel's health, alerts, the previous quorum and its id) with the
  native ``snapshot()`` and pushes it to every peer over wire method 6, so
  the standby that wins the next election resumes with the dead leader's
  view: quorum formation restarts on the fast path with the quorum id
  unchanged (the managers do not reconfigure), and /metrics history has no
  reset.

A follower keeps its native server in the follower role, which answers
Quorum and Heartbeat with ``"not the leader; leader=<addr> ..."`` and HTTP
with a 307 to the leader; the failover clients follow it.

When a replica wins an election at an epoch above 1 it emits a
``lighthouse_failover`` event (with ``leader_epoch``) through
:class:`~torchft_tpu_torch.metrics.MetricsLogger`, which
``obs/report.py``'s ``election_windows`` charges like quorum wait rather
than as a worker fault.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, Optional, Sequence

from torchft_tpu_torch.ha.backoff import DecorrelatedBackoff
from torchft_tpu_torch.ha.lease import FileLease, LeaseRecord

logger = logging.getLogger(__name__)

__all__ = ["HALighthouse"]


class HALighthouse:
    """One replica of an HA lighthouse group.

    Args:
        lease_path: shared lease file (the same path for every replica).
        peers: RPC addresses of the other replicas (the replication
            targets); this replica's own address is dropped, so the whole
            group's list may be given.
        lease_ms: lease duration: a standby takes over at most one lease
            period after the leader dies, and the serve-time guard's
            horizon.
        replicate_interval_ms: the leader's push cadence (default lease/3,
            the renewal cadence: a standby's state is at most this stale at
            a takeover).
        bind / http_bind / min_replicas / join_timeout_ms / quorum_tick_ms
            / heartbeat_timeout_ms: passed to the native server.
        owner_id: stable id in the lease file (default: the bound RPC
            address).
    """

    def __init__(
        self,
        lease_path: str,
        peers: Sequence[str] = (),
        lease_ms: int = 2000,
        bind: str = "127.0.0.1:0",
        http_bind: str = "127.0.0.1:0",
        min_replicas: int = 1,
        join_timeout_ms: int = 60000,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        replicate_interval_ms: Optional[int] = None,
        owner_id: Optional[str] = None,
    ) -> None:
        from torchft_tpu_torch._native import LighthouseServer
        from torchft_tpu_torch.metrics import MetricsLogger

        # A fresh replica must never answer as leader before the election
        # says so: the flag makes the native server start as a follower,
        # before its listeners open (a set_role(False) after construction
        # would leave a window while clients already call every address).
        # Scoped to this construction: a standalone LighthouseServer built
        # later in this process keeps its permanent-leader default.
        prev_flag = os.environ.get("TPUFT_HA_START_FOLLOWER")
        os.environ["TPUFT_HA_START_FOLLOWER"] = "1"
        try:
            self._server = LighthouseServer(
                bind=bind, min_replicas=min_replicas, join_timeout_ms=join_timeout_ms,
                quorum_tick_ms=quorum_tick_ms, heartbeat_timeout_ms=heartbeat_timeout_ms,
                http_bind=http_bind,
            )
        finally:
            if prev_flag is None:
                os.environ.pop("TPUFT_HA_START_FOLLOWER", None)
            else:
                os.environ["TPUFT_HA_START_FOLLOWER"] = prev_flag
        self._addr = self._server.address()
        self._http = self._server.http_address()
        self._server.set_role(False, "", "", 0, 0)  # no known leader yet
        self._owner = owner_id or self._addr
        self._lease = FileLease(lease_path, lease_ms, self._owner)
        self._lease_ms = int(lease_ms)
        self._peers = [p.strip() for p in peers if p.strip() and p.strip() != self._addr]
        self._replicate_s = (replicate_interval_ms or max(50, lease_ms // 3)) / 1000.0
        self._held: Optional[LeaseRecord] = None
        # Serializes every (_held, native role) transition: the replication
        # thread demotes on a higher-epoch answer while the election thread
        # promotes or renews; unserialized, a renewal landing just after
        # such a demotion would promote a deposed leader again.
        self._role_lock = threading.Lock()
        self._peer_clients: Dict[str, object] = {}
        self._stop = threading.Event()
        self._backoff = DecorrelatedBackoff(base_s=max(0.02, lease_ms / 1000.0 / 20.0),
                                            cap_s=max(0.1, lease_ms / 1000.0 / 3.0))
        self._metrics = MetricsLogger.from_env(f"lighthouse:{self._owner}")
        self._thread = threading.Thread(target=self._election_loop, name="tpuft_ha_election",
                                        daemon=True)
        self._thread.start()
        # Replication on a thread of its own: a push to a dead standby blocks
        # for its connect timeout, and in the election loop that stall would
        # delay the renewal past the lease, and the leader would flap.
        self._repl_thread = threading.Thread(target=self._replicate_loop,
                                             name="tpuft_ha_replicate", daemon=True)
        self._repl_thread.start()

    # -- introspection ------------------------------------------------------

    def address(self) -> str:
        return self._addr

    def http_address(self) -> str:
        return self._http

    def native_server(self):
        """The wrapped native server, for what composes with HA replica by
        replica: federation (:mod:`torchft_tpu_torch.federation` calls
        ``set_federation`` on every replica of an HA group; the native push
        loop fires only while the replica holds the lease).  The election
        loop owns the role: never call ``set_role`` on it."""
        return self._server

    def role(self) -> str:
        """``"leader"`` (a live lease) or ``"follower"``."""
        return "leader" if self._server.role() == 1 else "follower"

    def leader_epoch(self) -> int:
        return self._server.leader_epoch()

    def is_leader(self) -> bool:
        return self._held is not None

    # -- election -----------------------------------------------------------

    def _election_loop(self) -> None:
        while not self._stop.is_set():
            try:
                if self._held is not None:
                    self._leader_tick()
                    # Renew at about lease/3: two missed ticks still renew
                    # before the expiry.
                    self._stop.wait(self._lease_ms / 1000.0 / 3.0)
                else:
                    self._follower_tick()
            except Exception:  # noqa: BLE001 - the election outlives transient
                # I/O errors (a lease file on flaky shared storage); the
                # serve-time guard bounds the damage.
                logger.exception("lighthouse %s: election tick failed", self._owner)
                self._stop.wait(self._backoff.next())

    def _leader_tick(self) -> None:
        held = self._held
        if held is None:
            return  # deposed by the replication thread since the loop's check
        renewed = self._lease.renew(held)
        if renewed is None:
            # Stolen or lapsed: demote now; the native role flip is what
            # stops this instance answering Quorum.
            current = self._lease.read()
            logger.warning("lighthouse %s: lease lost (now held by %s); demoting", self._owner,
                           current.owner if current else "<nobody>")
            self._demote(current)
            return
        with self._role_lock:
            if self._held is None:
                # Deposed by a higher epoch while the renewal was in flight:
                # stay a follower; the follower tick decides.
                return
            self._held = renewed
            self._server.set_role(True, self._addr, self._http, renewed.epoch,
                                  renewed.expires_ms)

    def _follower_tick(self) -> None:
        rec = self._lease.read()
        now_ms = int(time.time() * 1000)
        if rec is not None and not rec.expired(now_ms):
            # A live leader: follow it (the redirect's target) and poll
            # again shortly before the lease could expire.
            self._server.set_role(False, rec.rpc_address, rec.http_address, rec.epoch, 0)
            self._backoff.reset()
            self._stop.wait(min(self._lease_ms / 1000.0 / 4.0,
                                max(0.05, (rec.expires_ms - now_ms) / 1000.0)))
            return
        won = self._lease.try_acquire(self._addr, self._http)
        if won is None:
            # Lost the race, or raced a renewal: back off with jitter so
            # rivals decorrelate, then read again.
            self._stop.wait(self._backoff.next())
            return
        with self._role_lock:
            # The server's role and epoch first: is_leader() reads _held
            # without the lock, and must not report a leader whose epoch
            # the server does not hold yet.
            self._server.set_role(True, self._addr, self._http, won.epoch, won.expires_ms)
            self._held = won
        logger.warning("lighthouse %s: took over leadership (epoch %d)", self._owner, won.epoch)
        if won.epoch > 1:
            # Epoch 1 is the group's first election, not a failover.
            self._metrics.emit("lighthouse_failover", leader_epoch=won.epoch)

    def _demote(self, current: Optional[LeaseRecord]) -> None:
        with self._role_lock:
            self._held = None
            if current is not None:
                self._server.set_role(False, current.rpc_address, current.http_address,
                                      current.epoch, 0)
            else:
                self._server.set_role(False, "", "", self._server.leader_epoch(), 0)

    # -- replication --------------------------------------------------------

    def _replicate_loop(self) -> None:
        backoff = DecorrelatedBackoff(base_s=0.05, cap_s=self._replicate_s * 4)
        while not self._stop.is_set():
            try:
                if self._held is not None:
                    self._replicate()
                self._stop.wait(self._replicate_s)
            except Exception:  # noqa: BLE001 - as the election loop
                logger.exception("lighthouse %s: replicate tick failed", self._owner)
                self._stop.wait(backoff.next())

    def _replicate(self) -> None:
        """One push to every peer.  A failure is the peer's alone (a dead
        standby rejoins the stream when it restarts); a peer that answers
        with a higher epoch means this leader was deposed without noticing:
        it demotes at once."""
        if not self._peers:
            return
        from torchft_tpu_torch import _native, _wire

        snapshot = self._server.snapshot()
        for peer in self._peers:
            try:
                client = self._peer_clients.get(peer)
                if client is None:
                    client = _native._Client(peer, connect_timeout_ms=1000)
                    self._peer_clients[peer] = client
                raw = client.call(_native.LIGHTHOUSE_REPLICATE, snapshot, timeout_ms=2000)
                resp = _wire.decode("LighthouseReplicateResponse", raw)
                held = self._held
                if not resp.applied and held is not None and resp.leader_epoch > held.epoch:
                    logger.warning("lighthouse %s: peer %s holds epoch %d > own %d: deposed; "
                                   "demoting", self._owner, peer, resp.leader_epoch, held.epoch)
                    self._demote(self._lease.read())
                    return
            except Exception:  # noqa: BLE001 - a dead standby: redial next push
                client = self._peer_clients.pop(peer, None)
                if client is not None:
                    client.close()

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        if self._repl_thread.is_alive():
            self._repl_thread.join(timeout=5.0)
        if self._held is not None:
            # A clean handoff: push the freshest state, then expire the
            # lease now so a standby need not wait it out.
            try:
                self._replicate()
                self._lease.release(self._held)
            except Exception:  # noqa: BLE001
                logger.warning("lighthouse %s: handoff failed", self._owner, exc_info=True)
            self._held = None
        for client in self._peer_clients.values():
            client.close()
        self._peer_clients.clear()
        self._metrics.close()
        self._server.shutdown()
