"""Federated control plane: hierarchical lighthouses for O(1000) groups.

A single lighthouse — even the HA group of :mod:`torchft_tpu_torch.ha` — sees
every replica group's heartbeat and every manager's quorum stream.  At
O(1000) groups that fan-in is the scaling wall: per-instance RPC load,
/metrics scrape cost, and quorum-compute input all grow with N.  This
package splits the control plane into two tiers (docs/wire.md
"Federation"):

- **regional CHILD lighthouses** (:class:`RegionLighthouse`) own the
  heartbeats, straggler/slow-link sentinels, and goodput-ledger rollup
  for their region's groups — managers keep pointing at their region's
  address list, byte-for-byte the same client config as a flat
  deployment — and push a compact membership + ledger digest to the root
  over wire method 8 every ``push_interval_ms``;
- the **ROOT lighthouse** (:class:`RootLighthouse`) computes the global
  quorum from region digests only, so no instance ever sees more than
  O(N/R) traffic.  The root needs no special configuration — any
  lighthouse that receives digests serves as root — and hands the formed
  quorum plus drain/evict directives back down on each push response.

Either tier runs HA exactly as before: give a child or the root a lease
file and peers and it becomes a :class:`~torchft_tpu_torch.ha.HALighthouse`
group; digest pushes carry the child's leader epoch, and the root fences
stale-epoch pushers the same way replication fences deposed leaders.

A flat (single-tier) deployment never touches this package.  The port of
``torchft_tpu/federation/``: the same native lighthouse and wire, so a JAX
region and a port region can serve under one root.

Quickstart (two regions)::

    # region containers (one per region, near the GPU hosts)
    python -m torchft_tpu_torch.lighthouse_cli --bind 0.0.0.0:29510 \\
        --region us-east --root-addrs root-host:29500
    python -m torchft_tpu_torch.lighthouse_cli --bind 0.0.0.0:29510 \\
        --region eu-west --root-addrs root-host:29500

    # root (min_replicas = the GLOBAL group count the quorum waits for)
    python -m torchft_tpu_torch.lighthouse_cli --bind 0.0.0.0:29500 \\
        --min_replicas 64

    # managers in us-east: unchanged flat config, pointed at the region
    TPUFT_LIGHTHOUSE=us-east-host:29510 python train.py
"""

from typing import TYPE_CHECKING

__all__ = ["RegionLighthouse", "RootLighthouse"]

if TYPE_CHECKING:  # pragma: no cover — typing-only import
    from torchft_tpu_torch.federation.region import RegionLighthouse
    from torchft_tpu_torch.federation.root import RootLighthouse


def __getattr__(name: str):
    # As torchft_tpu_torch.ha: both classes load the native library (built
    # at first use); keep that out of `import torchft_tpu_torch.federation`.
    if name == "RegionLighthouse":
        from torchft_tpu_torch.federation.region import RegionLighthouse

        return RegionLighthouse
    if name == "RootLighthouse":
        from torchft_tpu_torch.federation.root import RootLighthouse

        return RootLighthouse
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
