"""Slice bootstrap: join one replica group's local ranks into one
``torch.distributed`` world.

The counterpart of ``torchft_tpu/multihost.py``.  A replica group (the
fault-tolerance unit the Manager coordinates) that spans several devices
runs one process a device here; before those processes can form their
in-group mesh (``parallel.ft_init_mesh``) they need one process group.
This module is the glue between the group's environment and that init:

  - WITHIN a group: :func:`initialize_slice`. Rank 0 publishes a
    coordinator address through the group's Store (the same framed-TCP
    store the Manager uses), and every rank calls
    ``torch.distributed.init_process_group`` against it.  The in-group
    mesh's collectives run on that process group.
  - ACROSS groups: the Manager, the lighthouse and the TCPCollective ring,
    unchanged; each local rank averages its own shards there.

Env contract (the JAX package's; here a "host" is one of the group's
processes):

  TPUFT_HOST_RANK        this process's rank within its group
  TPUFT_NUM_HOSTS        processes in the group (1: the init is a no-op)
  TPUFT_STORE            host:port of the group's Store (rendezvous)
  TPUFT_COORD_PORT       port rank 0 binds for the process group's own
                         TCP store (default 8476)
  TPUFT_SLICE_GEN        restart generation.  The Store can outlive the
                         group's processes, so without a generation in the
                         rendezvous key a restarted group would read the
                         PREVIOUS incarnation's coordinator address and
                         dial a dead process.

The coordinator's host is ``MASTER_ADDR`` (the group's store host, where
every server of the group is advertised), else this machine's host name.
The backend is the caller's choice, by name: NCCL where every rank has a
card of its own, gloo where ranks share a card or run on the CPU.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional

__all__ = ["SliceConfig", "slice_config_from_env", "initialize_slice"]


@dataclass(frozen=True)
class SliceConfig:
    host_rank: int
    num_hosts: int
    store_addr: Optional[str]
    coord_port: int = 8476
    # Restart incarnation; part of the rendezvous key so a restarted group
    # never reads a previous incarnation's coordinator from the Store.
    generation: int = 0

    @property
    def is_multihost(self) -> bool:
        return self.num_hosts > 1


def slice_config_from_env(env: Optional[dict] = None) -> SliceConfig:
    """Builds a SliceConfig from the TPUFT_HOST_RANK/TPUFT_NUM_HOSTS/
    TPUFT_STORE/TPUFT_COORD_PORT/TPUFT_SLICE_GEN environment contract."""
    e = os.environ if env is None else env
    return SliceConfig(
        host_rank=int(e.get("TPUFT_HOST_RANK", 0)),
        num_hosts=int(e.get("TPUFT_NUM_HOSTS", 1)),
        store_addr=e.get("TPUFT_STORE") or None,
        coord_port=int(e.get("TPUFT_COORD_PORT", 8476)),
        generation=int(e.get("TPUFT_SLICE_GEN", 0)),
    )


def _local_address(port: int) -> str:
    """The coordinator address peers dial: the group's store host."""
    return f"{os.environ.get('MASTER_ADDR') or socket.gethostname()}:{port}"


def initialize_slice(
    cfg: Optional[SliceConfig] = None,
    *,
    backend: str,
    key_prefix: str = "tpuft_slice",
    timeout_ms: int = 60000,
    _initialize=None,
) -> Optional[str]:
    """Joins this process into its group's ``torch.distributed`` world.

    Rank 0 publishes ``<key_prefix>/gen<g>/coordinator`` in the group
    Store; every rank blocks on that key, then calls ``_initialize``
    (default ``torch.distributed.init_process_group``) with ``backend``,
    ``init_method="tcp://<coordinator>"``, ``world_size`` and ``rank``.

    Returns the coordinator address used, or None for a one-process group
    (no-op)."""
    cfg = cfg or slice_config_from_env()
    if not cfg.is_multihost:
        return None
    if _initialize is None:
        import torch.distributed as dist

        def _initialize(**kw):
            dist.init_process_group(timeout=timedelta(milliseconds=timeout_ms), **kw)

    if cfg.store_addr is None:
        raise RuntimeError(
            "multi-process group bootstrap needs TPUFT_STORE (the replica "
            "group's StoreServer address) for coordinator rendezvous"
        )

    from torchft_tpu_torch.coordination import StoreClient

    store = StoreClient(cfg.store_addr, connect_timeout_ms=timeout_ms)
    try:
        key = f"{key_prefix}/gen{cfg.generation}/coordinator"
        if cfg.host_rank == 0:
            coordinator = _local_address(cfg.coord_port)
            store.set(key, coordinator.encode(), timeout_ms=timeout_ms)
        else:
            raw = store.get(key, wait=True, timeout_ms=timeout_ms)
            if raw is None:
                raise TimeoutError(
                    f"no coordinator published at {key!r} within {timeout_ms} ms"
                )
            coordinator = raw.decode()
    finally:
        store.close()

    _initialize(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=cfg.num_hosts,
        rank=cfg.host_rank,
    )
    return coordinator
