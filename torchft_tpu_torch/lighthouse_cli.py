"""Standalone Lighthouse server CLI.

The port of ``torchft_tpu/lighthouse_cli.py``, with every flag.  Usage::

    python -m torchft_tpu_torch.lighthouse_cli --bind [::]:29510 --min_replicas 2

The process imports torch with the package but never initializes CUDA: a
lighthouse runs beside the training processes and takes no device.

Highly-available mode (docs/architecture.md "HA lighthouse"): run N of
these, one per host, sharing a lease file on common storage and naming
each other as peers — a lease-based election keeps exactly one serving
as leader while the rest are warm standbys receiving continuous state
replication; clients set ``TPUFT_LIGHTHOUSE`` to the whole comma-separated
list and fail over automatically::

    python -m torchft_tpu_torch.lighthouse_cli --bind host1:29510 \
        --http_bind host1:29511 --lease-file /shared/tpuft_lease \
        --lease-ms 2000 --peers host2:29510,host3:29510

Federated mode (docs/wire.md "Federation"): pass ``--region`` and
``--root-addrs`` to run this instance as a regional CHILD that owns its
local groups' heartbeats/sentinels/ledger and pushes digests to the root;
the root is just another lighthouse (no extra flag — set its
``--min_replicas`` to the GLOBAL group count).  Combines with HA flags on
either tier::

    python -m torchft_tpu_torch.lighthouse_cli --bind 0.0.0.0:29510 \
        --region us-east --root-addrs root-host:29500
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading


def main(argv=None) -> None:
    """CLI entry: a standalone lighthouse server with the HTML dashboard,
    or one replica of an HA lighthouse group when ``--lease-file`` is
    given."""
    parser = argparse.ArgumentParser(description="torchft_tpu_torch lighthouse server")
    parser.add_argument("--bind", default="[::]:29510", help="RPC bind address")
    parser.add_argument("--http_bind", default="[::]:29511", help="dashboard bind address")
    parser.add_argument("--min_replicas", type=int, default=1)
    parser.add_argument("--join_timeout_ms", type=int, default=60000,
                        help="straggler wait before forming a smaller quorum")
    parser.add_argument("--quorum_tick_ms", type=int, default=100)
    parser.add_argument("--heartbeat_timeout_ms", type=int, default=5000)
    ha = parser.add_argument_group(
        "high availability",
        "run this process as one replica of an HA lighthouse group "
        "(lease-based leader election + leader->standby state replication)",
    )
    ha.add_argument(
        "--lease-file", default=None,
        help="shared lease file enabling HA mode (same path on every replica)",
    )
    ha.add_argument(
        "--lease-ms", type=int, default=2000,
        help="lease duration: the failover floor — a standby takes over at "
        "most one lease period after the leader dies (default 2000)",
    )
    ha.add_argument(
        "--peers", default="",
        help="comma-separated RPC addresses of the OTHER replicas (the "
        "replication push targets); this replica's own address is ignored",
    )
    fed = parser.add_argument_group(
        "federation",
        "run this instance as a regional child lighthouse of a two-tier "
        "federation (the root needs no flags — any lighthouse receiving "
        "digests serves as root)",
    )
    fed.add_argument(
        "--region", default="",
        help="region name enabling child mode; managers in this region keep "
        "their unchanged flat config pointed at this instance",
    )
    fed.add_argument(
        "--root-addrs", default="",
        help="comma-separated RPC addresses of the root lighthouse "
        "(leader + standbys when the root is HA)",
    )
    fed.add_argument(
        "--region-push-interval-ms", type=int, default=500,
        help="digest push cadence; keep well under the root's "
        "heartbeat_timeout_ms (the region-staleness horizon)",
    )
    args = parser.parse_args(argv)

    if bool(args.region) != bool(args.root_addrs):
        parser.error("--region and --root-addrs must be given together")

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(name)s %(message)s"
    )

    stop = threading.Event()
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGTERM, lambda *a: stop.set())

    if args.lease_file:
        from torchft_tpu_torch.ha.replica import HALighthouse

        server = HALighthouse(
            lease_path=args.lease_file,
            peers=[p for p in args.peers.split(",") if p.strip()],
            lease_ms=args.lease_ms,
            bind=args.bind,
            http_bind=args.http_bind,
            min_replicas=args.min_replicas,
            join_timeout_ms=args.join_timeout_ms,
            quorum_tick_ms=args.quorum_tick_ms,
            heartbeat_timeout_ms=args.heartbeat_timeout_ms,
        )
        if args.region:
            # Every HA replica enrolls; the native push loop only fires on
            # the current lease holder, so failover hands off the digest
            # stream without re-enrollment.
            server.native_server().set_federation(
                args.region, args.root_addrs, args.region_push_interval_ms
            )
        logging.info(
            "HA lighthouse replica on %s (dashboard at %s, lease %s, %d peer(s))",
            server.address(), server.http_address(), args.lease_file,
            len([p for p in args.peers.split(",") if p.strip()]),
        )
        stop.wait()
        server.shutdown()
        return

    from torchft_tpu_torch._native import LighthouseServer

    server = LighthouseServer(
        bind=args.bind,
        min_replicas=args.min_replicas,
        join_timeout_ms=args.join_timeout_ms,
        quorum_tick_ms=args.quorum_tick_ms,
        heartbeat_timeout_ms=args.heartbeat_timeout_ms,
        http_bind=args.http_bind,
    )
    if args.region:
        server.set_federation(
            args.region, args.root_addrs, args.region_push_interval_ms
        )
    logging.info("lighthouse listening on %s (dashboard at %s)",
                 server.address(), server.http_address())
    stop.wait()
    server.shutdown()


if __name__ == "__main__":
    main()
