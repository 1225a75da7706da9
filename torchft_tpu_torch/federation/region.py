"""Regional child lighthouse: the tier the managers actually talk to.

``RegionLighthouse`` is a thin composition, not a new server: it builds
the same native lighthouse a flat deployment runs (directly, or as one
replica of an :class:`~torchft_tpu_torch.ha.HALighthouse` group when given a
lease file) and enrolls it as the CHILD for one region via
``set_federation``.  Everything the flat lighthouse owned locally it
still owns — heartbeats, join admission, straggler and slow-link
sentinels, drain tombstones, the goodput ledger, /metrics and the flight
recorder — only quorum FORMATION moves to the root: the native push loop
reports a membership + ledger digest upward each interval and installs
the global quorum the root returns, which the local wait loops then hand
to the managers exactly as if it had been formed here.

Managers need no new configuration: ``TPUFT_LIGHTHOUSE=<this region's
address list>`` is the same client config, flat or federated.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["RegionLighthouse"]


class RegionLighthouse:
    """Child lighthouse serving one region of a federated control plane.

    Args:
        region: region name — the digest key at the root and the label on
            every ``tpuft_region_*`` gauge; must be unique per region and
            stable across child restarts.
        root_addrs: comma-separated RPC addresses of the root (leader +
            standbys when the root is HA) — the digest push fails over
            and follows "not the leader" redirects like any client.
        push_interval_ms: digest cadence.  The root declares the region
            stale (and drops its members from the global quorum) after
            its heartbeat timeout without a push, so keep this a small
            fraction of that; it also bounds federated quorum latency
            (install happens on the push after formation).
        lease_path / peers / lease_ms: when ``lease_path`` is set this
            replica joins an HA child group (:class:`torchft_tpu_torch.ha.HALighthouse`);
            every replica enrolls in the federation, and the native push
            loop only fires on the current lease holder, so failover
            hands off the digest stream without re-enrollment.
        bind / http_bind / min_replicas / join_timeout_ms / quorum_tick_ms
            / heartbeat_timeout_ms: forwarded to the native server.
            ``min_replicas`` is advisory here — the ROOT's floor gates
            the global quorum; a child never forms one.
    """

    def __init__(
        self,
        region: str,
        root_addrs: str,
        push_interval_ms: int = 500,
        bind: str = "127.0.0.1:0",
        http_bind: str = "127.0.0.1:0",
        min_replicas: int = 1,
        join_timeout_ms: int = 60000,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        lease_path: Optional[str] = None,
        peers: Sequence[str] = (),
        lease_ms: int = 2000,
    ) -> None:
        if not region:
            raise ValueError("region name must be non-empty")
        if not root_addrs:
            raise ValueError("root_addrs must name at least one root address")
        self.region = region
        self._ha = None
        if lease_path:
            from torchft_tpu_torch.ha import HALighthouse

            self._ha = HALighthouse(
                lease_path=lease_path,
                peers=peers,
                lease_ms=lease_ms,
                bind=bind,
                http_bind=http_bind,
                min_replicas=min_replicas,
                join_timeout_ms=join_timeout_ms,
                quorum_tick_ms=quorum_tick_ms,
                heartbeat_timeout_ms=heartbeat_timeout_ms,
            )
            self._server = self._ha.native_server()
        else:
            from torchft_tpu_torch._native import LighthouseServer

            self._server = LighthouseServer(
                bind=bind,
                min_replicas=min_replicas,
                join_timeout_ms=join_timeout_ms,
                quorum_tick_ms=quorum_tick_ms,
                heartbeat_timeout_ms=heartbeat_timeout_ms,
                http_bind=http_bind,
            )
        self._server.set_federation(region, root_addrs, push_interval_ms)
        logger.info(
            "region lighthouse '%s' at %s pushing to root %s every %dms%s",
            region,
            self._server.address(),
            root_addrs,
            push_interval_ms,
            " (HA replica)" if self._ha else "",
        )

    # -- introspection ------------------------------------------------------

    def address(self) -> str:
        """RPC address — what this region's managers point at."""
        return self._server.address()

    def http_address(self) -> str:
        return self._server.http_address()

    def regions(self) -> dict:
        """This child's own federation rollup (role "child", one row)."""
        return self._server.regions()

    def is_leader(self) -> bool:
        """True when this replica currently pushes digests (always true
        for a non-HA child)."""
        return self._ha.is_leader() if self._ha else True

    def native_server(self):
        """The wrapped native server — for evict/drain/flight access."""
        return self._server

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self) -> None:
        if self._ha is not None:
            self._ha.shutdown()
        else:
            self._server.shutdown()
