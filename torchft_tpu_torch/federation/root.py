"""Root lighthouse: global quorum over region digests.

The root is deliberately NOT a new server class in the native core — any
lighthouse that receives wire-method-8 digests ingests them and serves as
root.  ``RootLighthouse`` exists for the operator's side of that
contract: it pins the intent in configuration (the ``min_replicas`` floor
here is the GLOBAL one that gates quorum formation across all regions —
the single knob that stops the first region's digest from forming a
partial fleet quorum), optionally makes the root an HA group, and adds
the waiting/rollup helpers benches and scripts need.

The root sees only digests: no manager heartbeats, no per-replica RPC
stream.  Its fan-in is O(regions), which is the whole point of the tier
(docs/architecture.md "Federation").
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

__all__ = ["RootLighthouse"]


class RootLighthouse:
    """Root of a two-tier federated control plane.

    Args:
        min_replicas: GLOBAL quorum floor — the number of replica groups
            (across every region) a quorum must reach.  Set it to the
            expected fleet size: region digests arrive asynchronously,
            and this floor is what makes the first formation wait for
            every region instead of quorating on whichever digest landed
            first.
        lease_path / peers / lease_ms: when ``lease_path`` is set this
            replica joins an HA root group.  The region table itself is
            not replicated — a freshly promoted root repopulates it from
            the next round of pushes (one push interval), and child epoch
            fences re-latch on first contact; membership continuity comes
            from the replicated previous-quorum state, same as flat HA.
        bind / http_bind / join_timeout_ms / quorum_tick_ms /
            heartbeat_timeout_ms: forwarded to the native server.  The
            heartbeat timeout doubles as the region-staleness horizon: a
            region whose digests stop for longer is declared dead
            (``region_stale`` incident) and its members leave the global
            quorum.
    """

    def __init__(
        self,
        min_replicas: int = 1,
        bind: str = "127.0.0.1:0",
        http_bind: str = "127.0.0.1:0",
        join_timeout_ms: int = 60000,
        quorum_tick_ms: int = 100,
        heartbeat_timeout_ms: int = 5000,
        lease_path: Optional[str] = None,
        peers: Sequence[str] = (),
        lease_ms: int = 2000,
    ) -> None:
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
        logger.info(
            "root lighthouse at %s (global min_replicas=%d%s)",
            self._server.address(),
            min_replicas,
            ", HA replica" if self._ha else "",
        )

    # -- introspection ------------------------------------------------------

    def address(self) -> str:
        """RPC address — what every region's ``root_addrs`` points at."""
        return self._server.address()

    def http_address(self) -> str:
        return self._server.http_address()

    def regions(self) -> dict:
        """Fleet rollup: one row per region with digest freshness,
        replica counts, and ledger totals (same payload as
        ``GET /regions.json``)."""
        return self._server.regions()

    def wait_for_regions(
        self, count: int, timeout_s: float = 30.0, fresh: bool = True
    ) -> bool:
        """Block until ``count`` regions have registered (and are not
        stale when ``fresh``).  Bench/script convenience — federation
        itself never requires it."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            rows = self.regions().get("regions", [])
            live = [r for r in rows if not (fresh and r.get("stale"))]
            if len(live) >= count:
                return True
            time.sleep(0.05)
        return False

    def is_leader(self) -> bool:
        return self._ha.is_leader() if self._ha else True

    def native_server(self):
        """The wrapped native server — for evict/drain/flight access
        (a root-issued evict/drain propagates to the owning region on
        its next push response)."""
        return self._server

    # -- lifecycle ----------------------------------------------------------

    def shutdown(self) -> None:
        if self._ha is not None:
            self._ha.shutdown()
        else:
            self._server.shutdown()
